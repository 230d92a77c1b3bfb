"""Attention: GQA/MQA/MHA, sliding-window, softcap, qk_norm, KV cache.

Training/prefill uses a flash-style *blocked* formulation in eager torch: a
loop over query chunks with an online-softmax inner loop over KV chunks, so
peak activation memory is O(S * chunk) instead of O(S^2).  Local
(sliding-window) layers instead slice the exact KV span (chunk + window);
global layers sweep all KV chunks with a causal mask.  Each query chunk is
recomputed in the backward (``torch.utils.checkpoint``), so no
probabilities are kept for it.

Decode attends one new token against a ring-buffer cache of seq_len entries
written in place at ``pos % S`` -- no roll-copy, window masking by absolute
position distance.

This is the JAX package's ``models/attention.py`` op for op, float32
scores and softcap included; it calls no fused attention of a library
(none has the softcap, and one would change the numbers compared).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from .layers import Maker, Params, recompute, rms_norm, rope, softcap
from .sharding_rules import Spec

NEG = -2.0e38  # safe -inf for fp32 masks


def attn_specs(cfg: ArchConfig):
    """Pick shardable dims for the 16-way model axis (the reference's
    choice): shard heads (Megatron -- softmax stays local); if the head
    count doesn't divide (gemma3: 8 q heads, llama4: 40, whisper: 20),
    shard head_dim (pays a contraction all-reduce); kv projections that
    divide neither way are replicated.  ``cfg.attn_sharding ==
    "replicate"`` replicates every attention weight.  Returns (q, kv, o)
    specs."""
    from repro_torch.configs.base import MODEL_AXIS as MA

    none3 = Spec(None, None, None)
    if cfg.attn_sharding == "replicate":
        return none3, none3, none3

    def pick(n_heads, hd):
        if n_heads % MA == 0:
            return Spec(None, "model", None), "heads"
        if hd % MA == 0:
            return Spec(None, None, "model"), "hd"
        return none3, "none"

    q_spec, q_kind = pick(cfg.n_heads, cfg.hd)
    kv_spec, kv_kind = pick(cfg.n_kv_heads, cfg.hd)
    if q_kind == "heads" and kv_kind != "heads":
        # replicating the (small) kv projection keeps scores/softmax local
        kv_spec = none3
    elif q_kind == "hd" and cfg.hd % MA == 0:
        kv_spec = Spec(None, None, "model")  # align kv on hd
    if q_kind == "heads":
        o_spec = Spec("model", None, None)
    elif q_kind == "hd":
        o_spec = Spec(None, "model", None)
    else:
        o_spec = none3
    return q_spec, kv_spec, o_spec


def q_hd_sharded(cfg: ArchConfig) -> bool:
    """True when attention shards head_dim (heads don't divide the axis)."""
    q_spec, _, _ = attn_specs(cfg)
    return len(q_spec) == 3 and q_spec[2] == "model"


def init_attn(mk: Maker, cfg: ArchConfig) -> Params:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q_spec, kv_spec, o_spec = attn_specs(cfg)
    p = {
        "wq": mk.param((d, h, hd), q_spec),
        "wk": mk.param((d, kvh, hd), kv_spec),
        "wv": mk.param((d, kvh, hd), kv_spec),
        "wo": mk.param((h, hd, d), o_spec),
    }
    if cfg.qk_norm:
        p["q_norm"] = mk.zeros((hd,), Spec(None))
        p["k_norm"] = mk.zeros((hd,), Spec(None))
    return p


def _project_qkv(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 kv_x: torch.Tensor | None = None):
    """Returns q:(B,Sq,H,hd), k,v:(B,Skv,KVH,hd), with qk_norm and no rope yet."""
    kv_x = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_x, p["wv"])
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _scores(q, k, cfg: ArchConfig):
    """(B, KVH, G, Sq, Skv) grouped scores (GQA: G = H // KVH), float32."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * (hd ** -0.5)
    return softcap(s.to(torch.float32), cfg.attn_softcap)


def _apply_probs(probs, v):
    """(B,KVH,G,Sq,Skv) x (B,Skv,KVH,hd) -> (B,Sq,H,hd)."""
    b, kvh, g, sq, _ = probs.shape
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, kvh * g, -1)


def _keep(mask, s):
    return torch.where(mask, s, torch.full((), NEG, dtype=s.dtype, device=s.device))


# ---------------------------------------------------------------------------
# full (unblocked) attention -- encoder / cross-attention / tiny sequences
# ---------------------------------------------------------------------------

def full_attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
                   *, causal: bool, window: Optional[int] = None,
                   kv_x: torch.Tensor | None = None, use_rope: bool = True):
    """Returns (out, (k, v)) -- k/v post-rope, ready to become a cache."""
    b, sq, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, kv_x)
    skv = k.shape[1]
    if use_rope:
        q = rope(q, torch.arange(sq, device=x.device), cfg.rope_theta)
        k = rope(k, torch.arange(skv, device=x.device), cfg.rope_theta)
    s = _scores(q, k, cfg)
    if causal:
        iq = torch.arange(sq, device=x.device)[:, None]
        ik = torch.arange(skv, device=x.device)[None, :]
        mask = ik <= iq
        if window is not None:
            mask &= ik > iq - window
        s = _keep(mask, s)
    probs = torch.softmax(s, dim=-1)
    out = _apply_probs(probs, v)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)


# ---------------------------------------------------------------------------
# blocked causal attention (training / prefill)
# ---------------------------------------------------------------------------

def blocked_attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
                      *, window: Optional[int],
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """Causal self-attention, O(S*chunk) memory.  window=None -> global.
    Returns (out, (k, v)) like full_attention."""
    b, s, d = x.shape
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    if s % q_chunk or s % kv_chunk:
        return full_attention(p, cfg, x, causal=True, window=window)

    q, k, v = _project_qkv(p, cfg, x)
    pos = torch.arange(s, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)

    kvh, hd = k.shape[2], k.shape[3]
    g = cfg.n_heads // kvh
    nq = s // q_chunk
    row = torch.arange(q_chunk, device=x.device)[:, None]

    if window is not None and window + q_chunk < s:
        # local layers: slice the exact KV span; zero wasted FLOPs
        span = q_chunk + window
        span = min(span + (-span) % kv_chunk, s)
        col = torch.arange(span, device=x.device)[None, :]

        def one_q(qc, qs, k, v):
            ks_start = min(max(qs + q_chunk - span, 0), s - span)
            kc, vc = k[:, ks_start:ks_start + span], v[:, ks_start:ks_start + span]
            sc = _scores(qc, kc, cfg)  # (B,KVH,G,Cq,span)
            ipos, jpos = qs + row, ks_start + col
            sc = _keep((jpos <= ipos) & (jpos > ipos - window), sc)
            return _apply_probs(torch.softmax(sc, dim=-1), vc)  # (B,Cq,H,hd)

        outs = [recompute(one_q, q[:, qi * q_chunk:(qi + 1) * q_chunk], qi * q_chunk, k, v)
                for qi in range(nq)]
        out = torch.cat(outs, dim=1)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)

    # global layers: online-softmax sweep over all KV chunks
    nk = s // kv_chunk
    col = torch.arange(kv_chunk, device=x.device)[None, :]

    def one_q(qc, qs, k, v):
        ipos = qs + row
        m = torch.full((b, kvh, g, q_chunk), NEG, dtype=torch.float32, device=x.device)
        l = torch.zeros((b, kvh, g, q_chunk), dtype=torch.float32, device=x.device)
        acc = torch.zeros((b, kvh, g, q_chunk, hd), dtype=torch.float32, device=x.device)
        for kj in range(nk):
            kc = k[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            vc = v[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            sc = _scores(qc, kc, cfg)  # (B,KVH,G,Cq,Ck)
            jpos = kj * kv_chunk + col
            mask = jpos <= ipos
            if window is not None:
                mask &= jpos > ipos - window
            sc = _keep(mask, sc)
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp(m - m_new)
            pr = torch.exp(sc - m_new[..., None])
            l = l * corr + pr.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", pr.to(vc.dtype), vc)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / l[..., None]  # (B,KVH,G,Cq,hd)
        return out.reshape(b, kvh * g, q_chunk, hd).movedim(1, 2)

    outs = [recompute(one_q, q[:, qi * q_chunk:(qi + 1) * q_chunk], qi * q_chunk, k, v)
            for qi in range(nq)]
    out = torch.cat(outs, dim=1).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)


# ---------------------------------------------------------------------------
# decode with ring-buffer KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S, KVH, hd)
    v: torch.Tensor  # (B, S, KVH, hd)


def _ring_write(buf: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """``buf[:, slot] = new`` in place: the ring write of one token's k or v
    (B, 1, KVH, hd) into a (B, S, KVH, hd) cache.  DTensor has no strategy
    for ``index_copy_``; on a DTensor cache each rank writes its own shard
    (``new`` laid out like it, the slot moved into the rank's sequence
    shard, written only where it falls), so no rank touches another's."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(buf, DTensor):
        buf.index_copy_(1, slot.reshape(1), new.to(buf.dtype))
        return
    mesh, plc = buf.device_mesh, tuple(buf.placements)
    new = new.to(buf.dtype).redistribute(
        mesh, tuple(Replicate() if p == Shard(1) else p for p in plc))
    slot = slot.full_tensor() if isinstance(slot, DTensor) else slot
    local = buf.to_local()
    start, coord = 0, mesh.get_coordinate()
    for m, p in enumerate(plc):   # the shard index over the seq-sharding mesh dims
        if p == Shard(1):
            start = start * mesh.size(m) + coord[m]
    start *= local.shape[1]
    at = slot - start
    inside = (at >= 0) & (at < local.shape[1])
    at = at.clamp(0, local.shape[1] - 1).reshape(1)
    local.index_copy_(1, at, torch.where(inside, new.to_local(), local.index_select(1, at)))


def decode_attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
                     cache: KVCache, pos: torch.Tensor,
                     *, window: Optional[int],
                     cross: bool = False) -> tuple[torch.Tensor, KVCache]:
    """One-token step.  x: (B, 1, D); pos: () integer tensor -- absolute
    position of the new token; the cache holds the previous seq_len tokens
    (ring buffer).  The new token's k/v are written into ``cache`` in place
    (the cross cache is only read); returns (out, cache)."""
    s_max = cache.k.shape[1]
    q, k_new, v_new = _project_qkv(p, cfg, x)
    slot = torch.remainder(pos, s_max)
    if not cross:
        q = rope(q, pos[None], cfg.rope_theta)
        k_new = rope(k_new, pos[None], cfg.rope_theta)
        _ring_write(cache.k, k_new, slot)
        _ring_write(cache.v, v_new, slot)
    sc = _scores(q, cache.k, cfg)  # (B,KVH,G,1,S)
    if not cross:
        # absolute position of ring slot j given write head at slot(pos):
        # entries j hold positions pos - ((slot - j) mod S)
        j = torch.arange(s_max, device=x.device)
        age = torch.remainder(slot - j, s_max)  # 0 for the newest token
        mask = pos - age >= 0
        if window is not None:
            mask &= age < window
        sc = _keep(mask, sc)
    probs = torch.softmax(sc, dim=-1)
    out = _apply_probs(probs, cache.v)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


def init_kv_cache(cfg: ArchConfig, batch: int, seq: int, n_layers: int,
                  dtype: torch.dtype = torch.bfloat16, device=None) -> KVCache:
    """Zeroed (n_layers, batch, seq, KVH, hd) caches on ``device`` (the CUDA
    device by default)."""
    device = resolve_device(device)
    shape = (n_layers, batch, seq, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
