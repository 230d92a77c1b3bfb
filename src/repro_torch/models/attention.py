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
from .sharding_rules import Spec, dense, even_placements, on_shards, reduced, split_dim

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


def _hd_sharded(w, dim: int) -> bool:
    """Whether the DTensor ``w`` is sharded along its head_dim ``dim``."""
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(w, DTensor) and Shard(dim) in w.placements


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) x (D, N, hd) -> (B, S, N, hd): the reference's einsum
    "bsd,dhk->bshk" as the product with the flattened weight, its heads
    split off by ``split_dim`` (DTensor may shard the product's columns
    where the heads then do not divide the ranks: mixtral's 8 kv heads).
    A head_dim-sharded weight is flattened head_dim first, so that the
    sharded dim leads the merged one (a plain shard, where the other order
    makes DTensor's strided shard)."""
    d, n, hd = w.shape
    if _hd_sharded(w, 2):
        y = dense(x, w.transpose(1, 2).reshape(d, hd * n))
        return split_dim(y, -1, (hd, n)).transpose(-1, -2)
    return split_dim(dense(x, w.reshape(d, n * hd)), -1, (n, hd))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) x (H, hd, D) -> (B, S, D), the reference's einsum
    "bshk,hkd->bsd"; with a head_dim-sharded ``wo``, contracted head_dim
    first (see ``_proj``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    b, s, h, hd = out.shape
    if isinstance(out, DTensor) and isinstance(wo, DTensor):
        # the attention output split like wo's heads or head_dim, else
        # whole there: torch 2.11 refuses to merge (H, hd) with hd split
        # (a head_dim-sharded decode cache's) where wo splits the heads
        want = tuple(Shard(2) if q == Shard(0) and h % mesh_n == 0 else
                     Shard(3) if q == Shard(1) and hd % mesh_n == 0 else
                     (p if p in (Shard(0), Shard(1)) else Replicate())
                     for p, q, mesh_n in zip(out.placements, even_placements(wo),
                                             out.device_mesh.shape))
        if tuple(out.placements) != want:
            out = out.redistribute(out.device_mesh, want)
    if _hd_sharded(wo, 1):
        return dense(out.transpose(2, 3).reshape(b, s, hd * h),
                     wo.transpose(0, 1).reshape(hd * h, wo.shape[2]))
    return dense(out.reshape(b, s, h * hd), wo.reshape(h * hd, wo.shape[2]))


def _project_qkv(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 kv_x: torch.Tensor | None = None):
    """Returns q:(B,Sq,H,hd), k,v:(B,Skv,KVH,hd), with qk_norm and no rope yet."""
    kv_x = x if kv_x is None else kv_x
    q, k, v = _proj(x, p["wq"]), _proj(kv_x, p["wk"]), _proj(kv_x, p["wv"])
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _kv_for(kv, h0: int, h: int, g: int):
    """The kv heads query heads ``h0 .. h0 + h - 1`` read, and their group
    size: ``kv`` (B, S, KVH', hd) holds either exactly those kv heads (a
    shard aligned with the query shard, or every head when ``h0 == 0`` and
    ``h`` is all of them) or every kv head (replicated)."""
    kvh = kv.shape[2]
    if kvh * g == h:
        return kv, g
    if h % g == 0:
        return kv[:, :, h0 // g:h0 // g + h // g], g
    if g % h == 0:
        return kv[:, :, h0 // g:h0 // g + 1], h
    return kv.index_select(2, (h0 + torch.arange(h, device=kv.device)) // g), 1


def _scores_of(q, k, h0: int, g: int, scale: float):
    """(B, H, Sq, Skv) grouped scores of plain tensors, times ``scale``
    (hd ** -0.5 of the whole head_dim), unsoftcapped."""
    b, sq, h, hd = q.shape
    k, grp = _kv_for(k, h0, h, g)
    qg = q.reshape(b, sq, h // grp, grp, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale
    return s.reshape(b, h, sq, k.shape[1])


def _probs_times(probs, v, h0: int, g: int, eq: str):
    """(B, H, Sq, Skv) probabilities against (B, Skv, KVH', hd) values:
    ``eq`` "bhgqk,bkhd->bqhgd" (B, Sq, H, hd) or "...->bhgqd" (B, H, Sq,
    hd), from plain tensors."""
    b, h, sq, skv = probs.shape
    v, grp = _kv_for(v, h0, h, g)
    out = torch.einsum(eq, probs.reshape(b, h // grp, grp, sq, skv).to(v.dtype), v)
    return out.reshape((b, sq, h, -1) if eq.endswith("bqhgd") else (b, h, sq, -1))


def _by_heads(fn, a, kvs: tuple, head: int, key: Optional[int], out: str,
              whole: bool = False):
    """``fn(a, *kvs, h0)`` on each rank's shards where ``a`` (queries or
    probabilities, heads at dim ``head``, keys at ``key``) is a DTensor
    whose heads are sharded, or, with ``whole``, any DTensor (a chunk of
    blocked attention, which no op of crosses a batch row or a head); else
    ``fn(a, *kvs, 0)``, ``h0`` being the first query head the rank holds.
    DTensor would split the sharded heads into (KVH, G), which it refuses
    unless KVH divides the shard count (qwen3's 8 kv heads against 16 model
    ranks), and flattens batch x heads into one dim for the product, which
    torch 2.11 refuses; on each rank's shards both are plain reshapes.  Per
    mesh dim (uneven shards counted as replicated, ``even_placements``):
    heads sharded -> the ``kvs``' heads (dim 2) sharded alongside when KVH
    divides, else replicated (the rank reads the kv heads its query heads
    use); the ``kvs``' head_dim sharded (not with ``whole``) -> the
    product over each rank's slice, partial scores, head_dim-sharded
    outputs; batch sharded -> all of them; the ``kvs``' sequence sharded
    (sequence-parallel decode; not with ``whole``) -> ``a``'s keys sharded
    alongside, and the output keys-sharded ("scores") or partial; anything
    else gathered (a head_dim-sharded chunk -- llama4's 40 heads, whisper's
    20 -- runs on the whole head_dim, replicated over that mesh dim, where
    GSPMD would all-reduce its partial scores).  ``out`` names the output's
    layout: "scores" (B, H, Sq, Skv), "bqhd" (B, Sq, H, hd) or "bhqd"."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(a, DTensor):
        return fn(a, *kvs, 0)
    mesh = a.device_mesh
    ap = even_placements(a)
    kvp = [even_placements(kv) if isinstance(kv, DTensor) else (Replicate(),) * mesh.ndim
           for kv in kvs]
    if not whole and Shard(head) not in a.placements:
        return fn(a, *kvs, 0)
    out_head = {"scores": 1, "bqhd": 2, "bhqd": 1}[out]
    pa, pk, po = [], [[] for _ in kvs], []
    idx, n = 0, 1
    coord = mesh.get_coordinate()
    for m, p in enumerate(ap):
        size = mesh.size(m)
        qs = [ps[m] for ps in kvp]
        if not whole and Shard(3) in qs:
            # a decode cache split along its head_dim (KVH does not divide
            # the ranks): the product over each rank's slice of it, the
            # queries (one token) split alike, the scores partial
            pa.append(Shard(3) if key is None else Replicate())
            po.append(Partial() if out == "scores" else Shard(3))
            for q, acc in zip(qs, pk):
                acc.append(Shard(3) if q == Shard(3) else Replicate())
        elif p == Shard(head):
            idx, n = idx * size + coord[m], n * size
            pa.append(p), po.append(Shard(out_head))
            for kv, q, acc in zip(kvs, qs, pk):
                acc.append(Shard(2) if q == Shard(2) and kv.shape[2] % size == 0
                           else Replicate())
        elif p == Shard(0):
            pa.append(p), po.append(Shard(0))
            for acc in pk:
                acc.append(Shard(0))
        elif Shard(1) in qs and not whole:
            pa.append(Shard(key) if key is not None else Replicate())
            po.append(Shard(3) if out == "scores" else Partial())
            for q, acc in zip(qs, pk):
                acc.append(q)
        else:
            pa.append(Replicate()), po.append(Replicate())
            for acc in pk:
                acc.append(Replicate())
    h0 = idx * (a.shape[head] // n)
    return on_shards(lambda a_, *kv_: fn(a_, *kv_, h0), (a,) + tuple(kvs),
                     (tuple(pa),) + tuple(tuple(x) for x in pk), po, mesh)


def _scores_at(q, k, cfg: ArchConfig, g: int, h0: int):
    """(B, H, Sq, Skv) scores, float32, of query heads ``h0 ..``: query
    head h against kv head h // ``g`` (GQA), by the reference's grouped
    einsum (its (B, KVH, G, Sq, Skv) with the head dims merged)."""
    return softcap(_scores_of(q, k, h0, g, q.shape[-1] ** -0.5).to(torch.float32),
                   cfg.attn_softcap)


def _scores(q, k, cfg: ArchConfig):
    """(B, H, Sq, Skv) scores of (B, Sq, H, hd) queries against (B, Skv,
    KVH, hd) keys, float32: ``_scores_at``'s, the product on each rank's
    shards (partial where the head_dim is split) and the softcap after."""
    g, scale = q.shape[2] // k.shape[2], q.shape[-1] ** -0.5
    s = _by_heads(lambda q, k, h0: _scores_of(q, k, h0, g, scale), q, (k,), 2, None,
                  "scores")
    return softcap(reduced(s).to(torch.float32), cfg.attn_softcap)


def _apply_probs(probs, v):
    """(B, H, Sq, Skv) x (B, Skv, KVH, hd) -> (B, Sq, H, hd)."""
    g = probs.shape[1] // v.shape[2]
    return _by_heads(lambda p, v, h0: _probs_times(p, v, h0, g, "bhgqk,bkhd->bqhgd"),
                     probs, (v,), 1, 3, "bqhd")


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
    return _out_proj(out, p["wo"]), (k, v)


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

    g = q.shape[2] // k.shape[2]
    nq = s // q_chunk
    row = torch.arange(q_chunk, device=x.device)[:, None]

    if window is not None and window + q_chunk < s:
        # local layers: slice the exact KV span; zero wasted FLOPs
        span = q_chunk + window
        span = min(span + (-span) % kv_chunk, s)
        col = torch.arange(span, device=x.device)[None, :]

        def one_q_at(qc, qs, k, v, h0):
            ks_start = min(max(qs + q_chunk - span, 0), s - span)
            kc, vc = k[:, ks_start:ks_start + span], v[:, ks_start:ks_start + span]
            sc = _scores_at(qc, kc, cfg, g, h0)  # (B,H,Cq,span)
            ipos, jpos = qs + row, ks_start + col
            sc = _keep((jpos <= ipos) & (jpos > ipos - window), sc)
            return _probs_times(torch.softmax(sc, dim=-1), vc, h0, g,
                                "bhgqk,bkhd->bqhgd")  # (B,Cq,H,hd)

        def one_q(qc, qs, k, v):
            return _by_heads(lambda qc, k, v, h0: one_q_at(qc, qs, k, v, h0), qc, (k, v),
                             2, None, "bqhd", whole=True)

        outs = [recompute(one_q, q[:, qi * q_chunk:(qi + 1) * q_chunk], qi * q_chunk, k, v)
                for qi in range(nq)]
        out = torch.cat(outs, dim=1)
        return _out_proj(out, p["wo"]), (k, v)

    # global layers: online-softmax sweep over all KV chunks
    nk = s // kv_chunk
    col = torch.arange(kv_chunk, device=x.device)[None, :]

    def one_q_at(qc, qs, k, v, h0):
        ipos = qs + row
        for kj in range(nk):
            kc = k[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            vc = v[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            sc = _scores_at(qc, kc, cfg, g, h0)  # (B,H,Cq,Ck)
            if kj == 0:
                # the running max and sum laid out like the scores (a
                # plain tensor would be the global batch on every rank)
                m = torch.full_like(sc[..., 0], NEG)
                l = torch.zeros_like(sc[..., 0])
            jpos = kj * kv_chunk + col
            mask = jpos <= ipos
            if window is not None:
                mask &= jpos > ipos - window
            sc = _keep(mask, sc)
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp(m - m_new)
            pr = torch.exp(sc - m_new[..., None])
            l = l * corr + pr.sum(-1)
            pv = _probs_times(pr, vc, h0, g, "bhgqk,bkhd->bhgqd")
            acc = (torch.zeros_like(pv, dtype=torch.float32) if kj == 0 else acc) \
                * corr[..., None] + pv
            m = m_new
        return (acc / l[..., None]).movedim(1, 2)  # (B,Cq,H,hd)

    def one_q(qc, qs, k, v):
        return _by_heads(lambda qc, k, v, h0: one_q_at(qc, qs, k, v, h0), qc, (k, v),
                         2, None, "bqhd", whole=True)

    outs = [recompute(one_q, q[:, qi * q_chunk:(qi + 1) * q_chunk], qi * q_chunk, k, v)
            for qi in range(nq)]
    out = torch.cat(outs, dim=1).to(x.dtype)
    return _out_proj(out, p["wo"]), (k, v)


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
    sc = _scores(q, cache.k, cfg)  # (B,H,1,S)
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
    return _out_proj(out, p["wo"]), cache


def init_kv_cache(cfg: ArchConfig, batch: int, seq: int, n_layers: int,
                  dtype: torch.dtype = torch.bfloat16, device=None) -> KVCache:
    """Zeroed (n_layers, batch, seq, KVH, hd) caches on ``device`` (the CUDA
    device by default)."""
    device = resolve_device(device)
    shape = (n_layers, batch, seq, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
