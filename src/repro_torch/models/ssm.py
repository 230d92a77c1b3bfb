"""Mamba2 (SSD) block: scalar-per-head decay through the shared GLA engine.

Faithful structure: fused in_proj -> [z | xBC | dt]; causal depthwise conv
(k=4) on xBC; per-head decay a_t = exp(-softplus(dt + bias) * exp(A_log));
y = C^T h with h the gated state; D skip; gated RMSNorm; out_proj.
n_groups = 1 (B/C shared across heads), headdim 64: the zamba2-2.7b layout.

The JAX package's ``models/ssm.py`` op for op, its float32 islands (the
decay and the recurrent state, ``torch.float32`` read at call time)
included, and each parameter's logical sharding spec the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from .gla import chunked_gla, gla_decode_step
from .layers import Maker, Params, rms_norm
from .sharding_rules import Spec, batch_local, dense, gathered, shard

CONV_K = 4


class MambaState(NamedTuple):
    ssm: torch.Tensor    # (B, H, N, hd)
    conv: torch.Tensor   # (B, CONV_K-1, d_conv_channels)


def _dims(cfg: ArchConfig):
    d_inner = 2 * cfg.d_model
    heads = cfg.ssm_heads or d_inner // 64
    hd = d_inner // heads
    n = cfg.ssm_state
    return d_inner, heads, hd, n


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference takes it (``logaddexp(x, 0)``, with
    no linear cut-off above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_mamba(mk: Maker, cfg: ArchConfig) -> Params:
    d = cfg.d_model
    d_inner, heads, hd, n = _dims(cfg)
    d_conv = d_inner + 2 * n
    return {
        "in_proj": mk.param((d, 2 * d_inner + 2 * n + heads), Spec(None, "model")),
        "conv_w": mk.param((CONV_K, d_conv), Spec(None, "model"), scale=CONV_K ** -0.5),
        "conv_b": mk.zeros((d_conv,), Spec("model")),
        "a_log": mk.param((heads,), Spec("model"), scale=1.0),
        "dt_bias": mk.param((heads,), Spec("model"), scale=1.0),
        "d_skip": mk.param((heads,), Spec("model"), scale=1.0),
        "norm": mk.zeros((d_inner,), Spec("model")),
        "out_proj": mk.param((d_inner, d), Spec("model", None)),
    }


def _split(cfg: ArchConfig, zxbcdt: torch.Tensor):
    d_inner, heads, hd, n = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: 2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt


def _conv_train(p: Params, xbc: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv as a sum of shifted scalings (k=4), on each
    rank's batch rows."""
    def conv(xbc, w, bias):
        acc = bias + xbc * w[CONV_K - 1]
        for i in range(1, CONV_K):
            shifted = F.pad(xbc, (0, 0, i, 0))[:, : xbc.shape[1]]
            acc = acc + shifted * w[CONV_K - 1 - i]
        return F.silu(acc)

    return batch_local(conv, (xbc,), (p["conv_w"], p["conv_b"]))


def _log_decay(p: Params, dt: torch.Tensor):
    """(softplus(dt + bias), its log decay -softplus(..) exp(A_log)) in
    float32; dt: (..., H)."""
    f32 = torch.float32
    dt_act = softplus(dt.to(f32) + gathered(p["dt_bias"]).to(f32))
    return dt_act, (-dt_act * torch.exp(gathered(p["a_log"]).to(f32)))[..., None]


def apply_mamba(p: Params, cfg: ArchConfig, x: torch.Tensor,
                chunk: int = 64) -> torch.Tensor:
    b, s, _ = x.shape
    d_inner, heads, hd, n = _dims(cfg)
    z, xbc, dt = _split(cfg, shard(dense(x, p["in_proj"]), "batch", None, None))
    xbc = _conv_train(p, xbc)
    xin = xbc[..., :d_inner]
    bmat = xbc[..., d_inner: d_inner + n]
    cmat = xbc[..., d_inner + n:]

    dt_act, log_decay = _log_decay(p, dt)                       # (B,S,H), (B,S,H,1)
    v = xin.reshape(b, s, heads, hd) * dt_act[..., None].to(xin.dtype)
    k = bmat[:, :, None, :].expand(b, s, heads, n)
    q = cmat[:, :, None, :].expand(b, s, heads, n)

    y, _ = chunked_gla(q, k, v, log_decay, mode="mamba", chunk=chunk)
    y = y + xin.reshape(b, s, heads, hd) * gathered(p["d_skip"]).to(y.dtype)[:, None]
    y = y.reshape(b, s, d_inner)
    y = rms_norm(y * F.silu(z), gathered(p["norm"]))
    return dense(y, p["out_proj"])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_mamba_state(cfg: ArchConfig, batch: int, n_layers: int, dtype=None,
                     device=None) -> MambaState:
    """Zeroed (n_layers, ...) states, float32 unless ``dtype`` says
    otherwise, on ``device`` (the CUDA device by default)."""
    d_inner, heads, hd, n = _dims(cfg)
    device = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    shapes = ((n_layers, batch, heads, n, hd),
              (n_layers, batch, CONV_K - 1, d_inner + 2 * n))
    return MambaState(*(torch.zeros(s, dtype=dtype, device=device) for s in shapes))


def mamba_decode_step(p: Params, cfg: ArchConfig, x: torch.Tensor,
                      state: MambaState) -> tuple[torch.Tensor, MambaState]:
    """x: (B, 1, D); state: one layer's (B, ...) slices.  Returns (out,
    the new state, in the state's dtypes)."""
    b = x.shape[0]
    d_inner, heads, hd, n = _dims(cfg)
    f32 = torch.float32
    z, xbc, dt = _split(cfg, shard(dense(x, p["in_proj"]), "batch", None, None))
    xbc = xbc[:, 0]  # (B, C_conv)
    # conv with the carried last K-1 inputs, in the wider of the two dtypes
    wide = torch.promote_types(state.conv.dtype, xbc.dtype)
    hist = torch.cat([state.conv.to(wide), xbc[:, None].to(wide)], dim=1)  # (B, K, C)
    out = batch_local(lambda h, w, bias: bias + torch.einsum("bkc,kc->bc", h.to(f32),
                                                             w.to(f32)),
                      (hist,), (p["conv_w"], p["conv_b"]))
    xbc_c = F.silu(out).to(x.dtype)
    new_conv = hist[:, 1:]

    xin = xbc_c[..., :d_inner]
    bmat = xbc_c[..., d_inner: d_inner + n]
    cmat = xbc_c[..., d_inner + n:]
    dt_act, log_decay = _log_decay(p, dt[:, 0])                 # (B,H), (B,H,1)

    v = xin.reshape(b, heads, hd) * dt_act[..., None].to(xin.dtype)
    k = bmat[:, None, :].expand(b, heads, n)
    q = cmat[:, None, :].expand(b, heads, n)
    y, new_ssm = gla_decode_step(q, k, v, log_decay, state.ssm.to(f32), mode="mamba")
    y = y + xin.reshape(b, heads, hd) * gathered(p["d_skip"]).to(y.dtype)[:, None]
    y = y.reshape(b, 1, d_inner)
    y = rms_norm(y * F.silu(z), gathered(p["norm"]))
    out = dense(y, p["out_proj"])
    return out, MambaState(new_ssm.to(state.ssm.dtype), new_conv.to(state.conv.dtype))
