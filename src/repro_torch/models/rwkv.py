"""RWKV-6 (Finch) time-mix block: data-dependent per-channel decay.

Signature features kept faithful: token-shift lerp mixes for r/k/v/g/w, the
low-rank ("lora") data-dependent decay  w_t = exp(-exp(w0 + tanh(x_w A) B)),
per-head u bonus on the current token, per-head group norm on the readout,
SiLU gate.  The recurrence runs through the shared chunked GLA engine in
vector-decay mode.  Channel-mix (the FFN half) lives in layers.py
(``rwkv_channel_mix``).

The JAX package's ``models/rwkv.py`` op for op, its float32 islands (the
decay, the group norm's statistics and the recurrent state,
``torch.float32`` read at call time) included.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from .gla import chunked_gla, gla_decode_step
from .layers import Maker, Params, token_mix
from .sharding_rules import Spec, batch_local, dense, entry, split_dim

LORA_R = 64


class RWKVState(NamedTuple):
    wkv: torch.Tensor       # (B, H, hd, hd)
    shift_tm: torch.Tensor  # (B, 1, D) last token seen by time-mix
    shift_cm: torch.Tensor  # (B, 1, D) last token seen by channel-mix


def init_rwkv_tm(mk: Maker, cfg: ArchConfig) -> Params:
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.hd
    if h * hd != d:
        raise ValueError(f"{cfg.name}: {h} heads x {hd} is not d_model {d}")
    return {
        "mix_r": mk.param((d,), Spec(None), scale=0.5),
        "mix_k": mk.param((d,), Spec(None), scale=0.5),
        "mix_v": mk.param((d,), Spec(None), scale=0.5),
        "mix_g": mk.param((d,), Spec(None), scale=0.5),
        "mix_w": mk.param((d,), Spec(None), scale=0.5),
        "wr": mk.param((d, d), Spec(None, "model")),
        "wk": mk.param((d, d), Spec(None, "model")),
        "wv": mk.param((d, d), Spec(None, "model")),
        "wg": mk.param((d, d), Spec(None, "model")),
        "w0": mk.param((d,), Spec("model"), scale=1.0),
        "w_lora_a": mk.param((d, LORA_R), Spec(None, None)),
        "w_lora_b": mk.param((LORA_R, d), Spec(None, "model"), scale=0.01),
        "u": mk.param((h, hd), Spec("model", None), scale=0.5),
        "ln_x": mk.zeros((d,), Spec("model")),
        "wo": mk.param((d, d), Spec("model", None)),
    }


def _mixes(p: Params, x: torch.Tensor, x_prev: torch.Tensor | None):
    """The r, k, v, g, w lerps of ``x`` and its token shift (``x_prev``:
    the carried last token, or None from a sequence's start)."""
    return token_mix(x, x_prev, tuple(p[f"mix_{n}"] for n in "rkvgw"))


def _log_decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """w_t = exp(-exp(...)): returns log w_t (strictly negative).  The
    low-rank product's gradient, partial over "model" from the
    column-sharded ``w_lora_b``, is reduced once at its input (``entry``):
    left to DTensor, torch 2.13 reduce-scatters it and gathers it back."""
    f32 = torch.float32
    lora = dense(entry(torch.tanh(dense(xw.to(f32), p["w_lora_a"].to(f32)))),
                 p["w_lora_b"].to(f32))
    return -torch.exp(p["w0"].to(f32) + lora)


def _group_norm(y: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm of the (..., H, hd) readout, merged to (..., D),
    on each rank's batch rows (``batch_local``: the merge's backward splits
    a sharded gradient, which DTensor (torch 2.11) refuses)."""
    def norm(y, gamma):
        yh = y.to(torch.float32)
        inv = torch.rsqrt(torch.mean(yh * yh, -1, keepdim=True) + 1e-5)
        yn = (yh * inv).reshape(y.shape[:-2] + (-1,))
        return yn.to(y.dtype) * (1.0 + gamma.to(y.dtype))

    return batch_local(norm, (y,), (gamma,))


def apply_rwkv_tm(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  chunk: int = 32, pair_bf16: bool = False) -> torch.Tensor:
    h, hd = cfg.n_heads, cfg.hd
    xr, xk, xv, xg, xw = _mixes(p, x, None)
    r = split_dim(dense(xr, p["wr"]), -1, (h, hd))
    k = split_dim(dense(xk, p["wk"]), -1, (h, hd))
    v = split_dim(dense(xv, p["wv"]), -1, (h, hd))
    g = F.silu(dense(xg, p["wg"]))
    ld = split_dim(_log_decay(p, xw), -1, (h, hd))
    y, _ = chunked_gla(r, k, v, ld, u=p["u"], mode="rwkv", chunk=chunk, pair_bf16=pair_bf16)
    y = _group_norm(y, p["ln_x"])
    return dense(y * g, p["wo"])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_rwkv_state(cfg: ArchConfig, batch: int, n_layers: int, dtype=None,
                    device=None) -> RWKVState:
    """Zeroed (n_layers, ...) states, float32 unless ``dtype`` says
    otherwise, on ``device`` (the CUDA device by default)."""
    h, hd, d = cfg.n_heads, cfg.hd, cfg.d_model
    device = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    shapes = ((n_layers, batch, h, hd, hd),
              (n_layers, batch, 1, d),
              (n_layers, batch, 1, d))
    return RWKVState(*(torch.zeros(s, dtype=dtype, device=device) for s in shapes))


def rwkv_tm_decode_step(p: Params, cfg: ArchConfig, x: torch.Tensor,
                        wkv: torch.Tensor, shift: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,1,D); wkv: (B,H,hd,hd); shift: (B,1,D) previous token features.
    Returns (out, the new wkv in its dtype, the new shift: ``x``)."""
    h, hd = cfg.n_heads, cfg.hd
    xr, xk, xv, xg, xw = _mixes(p, x, shift)
    r = split_dim(dense(xr, p["wr"])[:, 0], -1, (h, hd))
    k = split_dim(dense(xk, p["wk"])[:, 0], -1, (h, hd))
    v = split_dim(dense(xv, p["wv"])[:, 0], -1, (h, hd))
    g = F.silu(dense(xg, p["wg"]))[:, 0]
    ld = split_dim(_log_decay(p, xw)[:, 0], -1, (h, hd))
    y, new_wkv = gla_decode_step(r, k, v, ld, wkv.to(torch.float32), u=p["u"], mode="rwkv")
    y = _group_norm(y, p["ln_x"])
    out = dense(y * g, p["wo"])[:, None]
    return out, new_wkv.to(wkv.dtype), x
