"""n-TangentProp as a first-class LM-training feature: jet smoothness
regularization of a dense transformer w.r.t. its input embeddings.

TangentProp's original use was penalizing first derivatives along invariance
directions; the quasilinear n-jet makes arbitrary-order Sobolev penalties
affordable for transformers.  This propagates an exact order-n Taylor jet of
the *whole dense block stack* (RMSNorm -> GQA attention with softmax -> GeGLU/
SwiGLU) along an embedding-space direction and penalizes the top
coefficient's norm -- all through ``repro_torch.core.jet`` rules, the JAX
package's ``launch/ntp_reg.py`` op for op.

Cost control: the jet rides a token slice (first ``REG_TOKENS`` positions)
and full (unblocked) attention -- the regularizer is O(order^2) small
matmuls on a short sequence.  With ``cfg.remat`` each layer group's jet is
recomputed in the backward (``torch.utils.checkpoint``), as the model's own
forward is.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import jet as J
from repro_torch.models.layers import embed, recompute, rope
from repro_torch.models.transformer import _pattern_at, layer_chunks, stack_layers

REG_TOKENS = 64


def _jet_rope(x: J.Jet, positions, theta: float) -> J.Jet:
    return J.jmap(lambda c: rope(c, positions, theta), x)


def _jet_attn(lp, cfg: ArchConfig, x: J.Jet, window) -> J.Jet:
    s = x.shape[-2]
    pos = torch.arange(s, device=x.device)
    q = J.einsum("bsd,dhk->bshk", x, lp["wq"])
    k = J.einsum("bsd,dhk->bshk", x, lp["wk"])
    v = J.einsum("bsd,dhk->bshk", x, lp["wv"])
    if "q_norm" in lp:
        q = J.rms_norm(q, 1.0 + lp["q_norm"], offset=0.0)
        k = J.rms_norm(k, 1.0 + lp["k_norm"], offset=0.0)
    q = _jet_rope(q, pos, cfg.rope_theta)
    k = _jet_rope(k, pos, cfg.rope_theta)
    kvh, hd = lp["wk"].shape[1], lp["wk"].shape[2]
    g = cfg.n_heads // kvh
    qg = J.jmap(lambda c: c.reshape(c.shape[0], s, kvh, g, hd), q)
    scores = J.scale(J.einsum("bqhgd,bkhd->bhgqk", qg, k), hd ** -0.5)
    if cfg.attn_softcap:
        scores = J.scale(J.tanh(J.scale(scores, 1.0 / cfg.attn_softcap)),
                         cfg.attn_softcap)
    iq = torch.arange(s, device=x.device)[:, None]
    ik = torch.arange(s, device=x.device)[None, :]
    mask = ik <= iq
    if window is not None:
        mask &= ik > iq - window
    scores = J.where(mask, scores, J.const(
        torch.full((), -2e38, dtype=scores.dtype, device=scores.device), scores.order,
        like=scores))
    probs = J.softmax(scores, axis=-1)
    out = J.einsum("bhgqk,bkhd->bqhgd", probs, v)
    out = J.jmap(lambda c: c.reshape(c.shape[0], s, kvh * g, hd), out)
    return J.einsum("bshk,hkd->bsd", out, lp["wo"])


def _jet_mlp(lp, cfg: ArchConfig, x: J.Jet) -> J.Jet:
    if cfg.mlp in ("swiglu", "geglu"):
        gu = J.einsum("bsd,dtf->bstf", x, lp["wi"])
        gate = J.jmap(lambda c: c[..., 0, :], gu)
        up = J.jmap(lambda c: c[..., 1, :], gu)
        act = J.silu(gate) if cfg.mlp == "swiglu" else J.gelu(gate)
        return J.einsum("bsf,fd->bsd", J.mul(act, up), lp["wo"])
    if cfg.mlp == "gelu_mlp":
        return J.einsum("bsf,fd->bsd", J.gelu(J.einsum("bsd,df->bsf", x, lp["wi"])),
                        lp["wo"])
    raise NotImplementedError(cfg.mlp)


def _jet_block(lp, cfg: ArchConfig, x: J.Jet, j: int, ct: torch.dtype) -> J.Jet:
    """One dense block on a jet, its parameters cast to ``ct``."""
    window = cfg.window if _pattern_at(cfg, j) == "local" else None
    h = J.rms_norm(x, lp["ln1"].to(ct), offset=1.0)
    x = J.add(x, _jet_attn(_f32(lp["attn"], ct), cfg, h, window))
    h = J.rms_norm(x, lp["ln2"].to(ct), offset=1.0)
    return J.add(x, _jet_mlp(_f32(lp["ffn"], ct), cfg, h))


def jet_forward_dense(params, cfg: ArchConfig, tokens: torch.Tensor,
                      order: int, direction: torch.Tensor | None = None) -> J.Jet:
    """Order-n jet of final hidden states along an embedding direction.

    Dense attention stacks only: the decoder's blocks, without an encoder's
    cross-attention or a VLM prefix (as the reference)."""
    if cfg.block_type != "attn" or cfg.moe is not None:
        raise NotImplementedError("jet regularizer: dense attention archs only")
    # compute dtype follows params (tests run f64)
    ct = torch.float64 if params["final_norm"].dtype == torch.float64 else torch.float32
    x0 = embed(params["embed"], tokens, cfg).to(ct)
    if direction is None:
        direction = torch.sign(torch.sin(torch.arange(x0.numel(), dtype=ct, device=x0.device))
                               ).reshape(x0.shape) * (x0.shape[-1] ** -0.5)
    x = J.seed(x0, direction.to(x0.dtype), order)

    def run(coeffs, chunk):
        x = J.Jet(coeffs)
        for j, lp in chunk:
            x = _jet_block(lp, cfg, x, j, ct)
        return x.coeffs

    coeffs = x.coeffs
    for chunk, remat in layer_chunks(params["stack"], cfg):
        coeffs = recompute(run, coeffs, chunk, when=remat)
    return J.rms_norm(J.Jet(coeffs), params["final_norm"].to(ct), offset=1.0)


def dense_primal(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The computation the jet carries, on plain embeddings ``x``: the
    block stack and the final norm through the same rules at order 0 (an
    order-0 jet is the standard computation), in ``x``'s dtype.  Nested
    forward-mode autodiff through it is an oracle for the jet's orders."""
    h = J.Jet(x[None])
    for j, lp in stack_layers(params["stack"], cfg):
        h = _jet_block(lp, cfg, h, j, x.dtype)
    return J.rms_norm(h, params["final_norm"].to(x.dtype), offset=1.0).coeffs[0]


def _f32(tree, ct: torch.dtype):
    return {k: _f32(v, ct) if isinstance(v, dict) else v.to(ct) for k, v in tree.items()}


def ntp_smoothness(params, cfg: ArchConfig, batch, order: int) -> torch.Tensor:
    """Mean squared top Taylor coefficient of the hidden states: an exact
    order-n Sobolev penalty, one quasilinear forward."""
    tokens = batch["tokens"][:, :REG_TOKENS]
    jet = jet_forward_dense(params, cfg, tokens, order)
    return torch.mean(jet.coeffs[order] ** 2)
