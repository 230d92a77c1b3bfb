"""Deterministic synthetic token pipeline for LM training and serving launchers.

Streams batches without any filesystem dependency: tokens are a
counter-based function of (0x5EED, step, row offset) -- a CPU
``torch.Generator`` seeded from those counters, the draw then moved to
``device`` (the CUDA device by default) -- so every host of a multi-host
job can materialize exactly its own rows, restarts are reproducible from
the step counter alone, and one step gives the same batch on every device.
A markov-ish structure (mixing the previous token id into the draw) gives
the model something learnable beyond uniform noise: the reference's
``(base // 7 + shifted // 3) % vocab``.

The JAX package draws with ``jax.random``, whose numbers torch cannot
reproduce: the two packages' batches differ for one step, and tests that
compare them pass tokens explicitly.
"""

from __future__ import annotations

from typing import Dict, Iterator

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.device import resolve_device

_SEED = 0x5EED
# one stream per kind of draw, so tokens, frames and patch embeddings of a
# step never share numbers
_TOKENS, _FRAMES, _IMAGE = 0, 1, 2


def _generator(step: int, stream: int, offset: int = 0) -> torch.Generator:
    """A CPU generator seeded from the counters (_SEED, step, stream, offset)."""
    seed = _SEED
    for c in (step, stream, offset):
        seed = (seed * 1_000_003 + c) % (1 << 63)
    return torch.Generator().manual_seed(seed)


def synthetic_batch(cfg: ArchConfig, shape: ShapeCfg, step: int,
                    batch_slice: slice | None = None,
                    dtype: torch.dtype = torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """Materialize the global (or host-sliced) batch for ``step`` on
    ``device``: ``tokens`` (B, S - image tokens) int64, plus ``frames``
    (B, encoder seq, d_model) for the encoder-decoder and ``image_embeds``
    (B, image tokens, 1024) for the VLM stub, both ``dtype``."""
    device = resolve_device(device)
    b = shape.global_batch
    if batch_slice is not None:
        b = batch_slice.stop - batch_slice.start
        offset = batch_slice.start
    else:
        offset = 0
    n_text = shape.seq_len - (cfg.vlm_image_tokens or 0)
    base = torch.randint(0, cfg.vocab, (b, n_text), generator=_generator(step, _TOKENS, offset))
    # markov-ish: token_t depends on token_{t-1} (learnable bigram structure)
    shifted = torch.roll(base, 1, dims=1)
    toks = (base // 7 + shifted // 3) % cfg.vocab
    out: Dict[str, torch.Tensor] = {"tokens": toks.to(device)}
    if cfg.encoder is not None:
        out["frames"] = torch.randn((b, cfg.encoder.seq, cfg.d_model),
                                    generator=_generator(step, _FRAMES, offset),
                                    dtype=dtype).to(device)
    if cfg.vlm_image_tokens:
        from repro_torch.models.transformer import VLM_EMBED_DIM
        out["image_embeds"] = torch.randn((b, cfg.vlm_image_tokens, VLM_EMBED_DIM),
                                          generator=_generator(step, _IMAGE, offset),
                                          dtype=dtype).to(device)
    return out


def batch_stream(cfg: ArchConfig, shape: ShapeCfg, start_step: int = 0,
                 dtype: torch.dtype = torch.float32, device=None
                 ) -> Iterator[Dict[str, torch.Tensor]]:
    """``synthetic_batch`` of steps ``start_step``, ``start_step + 1``, ...
    without end: a restart resumes from its step counter alone."""
    step = start_step
    while True:
        yield synthetic_batch(cfg, shape, step, dtype=dtype, device=device)
        step += 1
