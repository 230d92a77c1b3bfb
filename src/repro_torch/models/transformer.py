"""Composable decoder/encoder stacks: the attention family of the LM pool.

Layer weights are *stacked over groups*: the layer pattern (gemma3's
5 local : 1 global) defines a group, and a loop over the leading axis of
the stacked leaves runs the groups (the reference scans them).  Layers that
don't fill a whole group are unrolled as "rest".  With ``cfg.remat`` each
group is recomputed in the backward (``torch.utils.checkpoint``), as the
reference checkpoints its scan body.

Entry points (functional; params are plain dict trees, the reference's
tree leaf for leaf):
  init_model(cfg, seed, device)          -> params
  train_loss(params, cfg, batch)         -> scalar loss, metrics
  prefill(params, cfg, batch)            -> last-pos logits + DecodeState
  decode_step(params, cfg, token, st)    -> logits, new DecodeState
  decode_state_specs(cfg, batch, seq)    -> a zeroed DecodeState

Ported so far: the dense archs, the VLM stub (patch embeddings through a
projector) and the encoder-decoder (cross-attention on encoder frames).
MoE layers, Mamba2/RWKV6 blocks and zamba2's shared attention raise
``NotImplementedError`` (ROADMAP Queue 1 item 6b); nothing is skipped
silently.  The reference's sharding hints have no meaning on one card and
are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from . import attention as attn
from .layers import (Maker, Params, StackedMaker, apply_mlp_block, embed, gelu,
                     init_embed, init_mlp_block, logits, recompute, rms_norm)

VLM_EMBED_DIM = 1024  # CLIP-large patch width (anyres frontend stub)

DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Knobs:
    """Performance knobs of the attention family (the reference's; its GLA
    and RWKV chunk knobs come with those blocks)."""

    q_chunk: int = 512
    kv_chunk: int = 1024
    aux_coef: float = 0.01


def _pattern_at(cfg: ArchConfig, j: int) -> str:
    return cfg.attn_pattern[j % len(cfg.attn_pattern)]


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for the parts of the LM pool the port
    does not have yet."""
    missing = []
    if cfg.block_type != "attn":
        missing.append(f"block_type {cfg.block_type!r}")
    if cfg.moe is not None:
        missing.append("MoE layers")
    if cfg.hybrid_shared_attn_every:
        missing.append("the hybrid shared-attention block")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP Queue 1 item 6b: "
            f"moe.py, ssm.py, rwkv.py, gla.py)")


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(mk: Maker, cfg: ArchConfig, cross: bool = False) -> Params:
    lp: Params = {"ln1": mk.zeros((cfg.d_model,)),
                  "attn": attn.init_attn(mk, cfg),
                  "ln2": mk.zeros((cfg.d_model,))}
    if cross:
        lp["lnx"] = mk.zeros((cfg.d_model,))
        lp["xattn"] = attn.init_attn(mk, cfg)
    lp["ffn"] = init_mlp_block(mk, cfg)
    return lp


def _init_stack(mk: Maker, cfg: ArchConfig, cross: bool = False,
                n_layers: int | None = None) -> Params:
    n_layers = n_layers if n_layers is not None else cfg.n_layers
    g = cfg.group
    n_groups, n_rest = n_layers // g, n_layers % g
    smk = StackedMaker(mk, n_groups)
    groups = {"layers": [_init_layer(smk, cfg, cross) for _ in range(g)]} \
        if n_groups else {"layers": []}
    rest = [_init_layer(mk, cfg, cross) for _ in range(n_rest)]
    return {"groups": groups, "rest": rest}


def init_model(cfg: ArchConfig, seed: int = 0, *, device=None) -> Params:
    """Random parameters of ``cfg`` in its dtype on ``device`` (the CUDA
    device by default), drawn from a generator on that device seeded with
    ``seed``.  The tree is the reference's ``init_model`` tree, key for
    key."""
    check_ported(cfg)
    device = resolve_device(device)
    mk = Maker(torch.Generator(device=device).manual_seed(seed), model_dtype(cfg), device)
    tree: Dict[str, Any] = {
        "embed": init_embed(mk, cfg),
        "final_norm": mk.zeros((cfg.d_model,)),
        "stack": _init_stack(mk, cfg, cross=cfg.encoder is not None),
    }
    if cfg.encoder is not None:
        tree["enc_stack"] = _init_stack(mk, cfg, n_layers=cfg.encoder.n_layers)
        tree["enc_norm"] = mk.zeros((cfg.d_model,))
    if cfg.vlm_image_tokens:
        tree["projector"] = {"w1": mk.param((VLM_EMBED_DIM, cfg.d_model)),
                             "w2": mk.param((cfg.d_model, cfg.d_model))}
    return tree


def _layer(p: Params, i: int) -> Params:
    """Group ``i`` of a stacked layer tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in p.items()}


def stack_layers(stack: Params, cfg: ArchConfig) -> Iterator[Tuple[int, Params]]:
    """(pattern index, layer params) of every layer of ``stack`` in order:
    the groups' layers (indexed within the group, as the reference's scan
    body does), then the rest (by absolute index)."""
    g = cfg.group
    layers = stack["groups"]["layers"]
    n_groups = layers[0]["ln1"].shape[0] if layers else 0
    for gi in range(n_groups):
        for j in range(g):
            yield j, _layer(layers[j], gi)
    for r, lp in enumerate(stack["rest"]):
        yield n_groups * g + r, lp


def layer_chunks(stack: Params, cfg: ArchConfig) -> List[Tuple[list, bool]]:
    """The layers of ``stack`` in the chunks the loop runs: one a group,
    recomputed in the backward under ``cfg.remat``, then the rest, never
    recomputed (as the reference checkpoints its scan body only)."""
    layers = list(stack_layers(stack, cfg))
    n = len(layers) - len(stack["rest"])
    return ([(layers[s:s + cfg.group], cfg.remat) for s in range(0, n, cfg.group)]
            + [(layers[n:], False)])


# ---------------------------------------------------------------------------
# sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _sublayer_seq(lp: Params, cfg: ArchConfig, x: torch.Tensor, j: int,
                  knobs: Knobs, *, causal: bool = True,
                  enc_out: torch.Tensor | None = None):
    """One layer.  Returns (x, kv, xkv); xkv None without cross-attention."""
    h = rms_norm(x, lp["ln1"])
    if causal:
        window = cfg.window if _pattern_at(cfg, j) == "local" else None
        a_out, akv = attn.blocked_attention(lp["attn"], cfg, h, window=window,
                                            q_chunk=knobs.q_chunk,
                                            kv_chunk=knobs.kv_chunk)
    else:
        a_out, akv = attn.full_attention(lp["attn"], cfg, h, causal=False)
    x = x + a_out
    xkv = None
    if "xattn" in lp and enc_out is not None:
        c_out, xkv = attn.full_attention(lp["xattn"], cfg, rms_norm(x, lp["lnx"]),
                                         causal=False, kv_x=enc_out, use_rope=False)
        x = x + c_out
    x = x + apply_mlp_block(lp["ffn"], cfg, rms_norm(x, lp["ln2"]))
    return x, akv, xkv


def _stack_seq(stack: Params, cfg: ArchConfig, x: torch.Tensor, knobs: Knobs,
               *, causal: bool = True, enc_out: torch.Tensor | None = None,
               collect_kv: bool = False):
    """The groups, then the unrolled rest.  Returns (x, collected) with
    collected = {"kv": [(k, v) per layer], "xkv": [(k, v) or None per
    layer]}, or None unless ``collect_kv``."""
    kvs, xkvs = [], []

    def run(x, chunk):
        out = []
        for j, lp in chunk:
            x, kv, xkv = _sublayer_seq(lp, cfg, x, j, knobs, causal=causal, enc_out=enc_out)
            if collect_kv:
                out.append((kv, xkv))
        return x, out

    for chunk, remat in layer_chunks(stack, cfg):
        x, out = recompute(run, x, chunk, when=remat)
        kvs += [kv for kv, _ in out]
        xkvs += [xkv for _, xkv in out]
    return x, ({"kv": kvs, "xkv": xkvs} if collect_kv else None)


def _fuse_inputs(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                 knobs: Knobs):
    """Frontend fusion; returns (x, enc_out, n_prefix)."""
    enc_out = None
    n_prefix = 0
    if cfg.encoder is not None:
        e = batch["frames"].to(model_dtype(cfg))
        e, _ = _stack_seq(params["enc_stack"], cfg, e, knobs, causal=False)
        enc_out = rms_norm(e, params["enc_norm"])
    x = embed(params["embed"], batch["tokens"], cfg)
    if cfg.vlm_image_tokens:
        pj = params["projector"]
        img = gelu(batch["image_embeds"].to(x.dtype) @ pj["w1"]) @ pj["w2"]
        x = torch.cat([img, x], dim=1)
        n_prefix = cfg.vlm_image_tokens
    return x, enc_out, n_prefix


def forward_seq(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                knobs: Knobs = Knobs(), collect_kv: bool = False):
    """Final hidden states of the whole sequence.  Returns (x, aux,
    n_prefix, collected); ``aux`` (the MoE balance loss) is 0 for every
    ported arch."""
    check_ported(cfg)
    x, enc_out, n_prefix = _fuse_inputs(params, cfg, batch, knobs)
    x, collected = _stack_seq(params["stack"], cfg, x, knobs, causal=True,
                              enc_out=enc_out, collect_kv=collect_kv)
    x = rms_norm(x, params["final_norm"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, n_prefix, collected


CE_CHUNK = 512


def _ce_of_chunk(params, cfg, xc, tc):
    """Sum of (lse - picked) over one sequence chunk; logits never outlive
    the chunk."""
    lg = logits(params["embed"], xc, cfg).to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tc[..., None])[..., 0]
    return torch.sum(lse - picked)


def train_loss(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
               knobs: Knobs = Knobs()):
    x, aux, n_prefix, _ = forward_seq(params, cfg, batch, knobs)
    tokens = batch["tokens"]
    if n_prefix:
        x = x[:, n_prefix:]
    x = x[:, :-1]
    tgt = tokens[:, 1:]
    n_pos = x.shape[0] * x.shape[1]
    s = x.shape[1]
    if s % CE_CHUNK == 0 and s > CE_CHUNK:
        ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(s // CE_CHUNK):
            xc = x[:, c * CE_CHUNK:(c + 1) * CE_CHUNK]
            tc = tgt[:, c * CE_CHUNK:(c + 1) * CE_CHUNK]
            ce_sum = ce_sum + recompute(
                lambda xc, tc: _ce_of_chunk(params, cfg, xc, tc), xc, tc)
    else:
        ce_sum = _ce_of_chunk(params, cfg, x, tgt)
    ce = ce_sum / n_pos
    loss = ce + knobs.aux_coef * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------

def decode_state_specs(cfg: ArchConfig, batch: int, seq: int, *, device=None) -> Dict[str, Any]:
    """A zeroed decode state for ``batch`` rows and a ring of ``seq``
    entries, at position ``seq - 1``, on ``device`` (the CUDA device by
    default).  The reference's abstract (shape-only) variant serves its
    dry-run and is not ported."""
    check_ported(cfg)
    device = resolve_device(device)
    st: Dict[str, Any] = {"pos": torch.tensor(seq - 1, dtype=torch.long, device=device),
                          "kv": attn.init_kv_cache(cfg, batch, seq, cfg.n_layers,
                                                   model_dtype(cfg), device)}
    if cfg.encoder is not None:
        st["cross_kv"] = attn.init_kv_cache(cfg, batch, cfg.encoder.seq, cfg.n_layers,
                                            model_dtype(cfg), device)
    return st


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _sublayer_decode(lp: Params, cfg: ArchConfig, x, j: int, kv: attn.KVCache,
                     cross_kv: attn.KVCache | None, pos):
    """One layer on one token; writes the token's k/v into ``kv``."""
    window = cfg.window if _pattern_at(cfg, j) == "local" else None
    out, _ = attn.decode_attention(lp["attn"], cfg, rms_norm(x, lp["ln1"]), kv, pos,
                                   window=window)
    x = x + out
    if "xattn" in lp and cross_kv is not None:
        cout, _ = attn.decode_attention(lp["xattn"], cfg, rms_norm(x, lp["lnx"]),
                                        cross_kv, pos, window=None, cross=True)
        x = x + cout
    return x + apply_mlp_block(lp["ffn"], cfg, rms_norm(x, lp["ln2"]))


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor, st: Dict[str, Any]):
    """token: (B, 1) integers.  Returns (logits (B, V), new state); ``st``
    is left as it was: its self-attention caches are copied once, as the
    reference's step copies them, and each layer writes its slot of the
    copy in place."""
    check_ported(cfg)
    pos = st["pos"]
    x = embed(params["embed"], token, cfg)
    kv = attn.KVCache(st["kv"].k.clone(), st["kv"].v.clone())
    for li, (j, lp) in enumerate(stack_layers(params["stack"], cfg)):
        cross = (attn.KVCache(st["cross_kv"].k[li], st["cross_kv"].v[li])
                 if "cross_kv" in st else None)
        x = _sublayer_decode(lp, cfg, x, j, attn.KVCache(kv.k[li], kv.v[li]), cross, pos)
    new_st = dict(st)
    new_st["pos"] = pos + 1
    new_st["kv"] = kv
    x = rms_norm(x, params["final_norm"])
    return logits(params["embed"], x, cfg)[:, 0], new_st


# ---------------------------------------------------------------------------
# prefill (attention-cache architectures)
# ---------------------------------------------------------------------------

def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            knobs: Knobs = Knobs(), pad_to: int | None = None):
    """Full-sequence forward that also builds the decode caches.

    ``pad_to`` sets the ring-buffer capacity (must exceed the prompt length
    by the number of tokens to be generated, or the ring evicts the oldest
    entries -- which is the intended streaming behavior at capacity).  The
    caches are the layers' post-rope k/v in layer order, zero-padded to the
    capacity; the encoder-decoder's cross caches keep the encoder's length
    (never ring-written).  Returns (last-position logits, DecodeState).
    """
    x, _, _, collected = forward_seq(params, cfg, batch, knobs, collect_kv=True)
    lg = logits(params["embed"], x[:, -1:], cfg)[:, 0]
    seq = x.shape[1]
    cap = pad_to or seq
    if cap < seq:
        raise ValueError(f"pad_to {cap} is below the prefilled length {seq}")

    def stacked(kvs) -> attn.KVCache:
        return attn.KVCache(torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))

    kv = stacked(collected["kv"])
    if cap > seq:
        kv = attn.KVCache(*(F.pad(c, (0, 0, 0, 0, 0, cap - seq)) for c in kv))
    st: Dict[str, Any] = {"pos": torch.tensor(seq, dtype=torch.long, device=x.device),
                          "kv": kv}
    if cfg.encoder is not None:
        st["cross_kv"] = stacked(collected["xkv"])
    return lg, st
