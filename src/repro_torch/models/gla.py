"""Chunked gated linear attention: the shared recurrence engine for Mamba2
(SSD) and RWKV-6 (Finch).

Recurrence (per head; Dk = key/state dim, Dv = value dim):

    S_t = diag(d_t) S_{t-1} + k_t v_t^T          d_t in (0,1]
    y_t = q_t^T S_t            (mamba mode: current token included, no bonus)
    y_t = q_t^T (S_{t-1} + diag(u) k_t v_t^T)    (rwkv mode: u-bonus diagonal)

Chunked evaluation (chunk C): with L_t = sum_{s<=t} log d_s (in-chunk cumsum),

    inter:  y_t += (q_t * exp(L_t'))  @ S_prev
    intra:  A[t,s] = sum_d q[t,d] k[s,d] exp(L'_t[d] - L_s[d]),  s <= t(-1)
    state:  S_new = diag(exp(L_C)) S_prev + sum_s (k_s * exp(L_C - L_s)) v_s^T

where L' is L shifted by one step in rwkv mode (decay applies *before* the
readout).  All exponents are differences with s <= t, hence <= 0: stable in
float32 however aggressive the decay.  The masked exponentials take
``exp(where(mask, diff, -inf))`` and zero the masked entries again, in that
order: the differences above the diagonal are positive and may overflow,
and an ``inf`` there times a zero would send a NaN into the gradient.

Two decay layouts share this code:
  * scalar per head (mamba2): the intra-chunk part is a (C, C) product of
    q and k times a decay matrix;
  * vector per channel (rwkv6): the pairwise tensor (C, C, Dk) is
    materialized per chunk (the honest cost of per-channel gating).

This is the JAX package's ``models/gla.py`` op for op, its float32 island
(the whole recurrence and its state, ``torch.float32`` read at call time)
included.  Its loop
over chunks recomputes each chunk in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` with
``nothing_saveable``), so the pairwise tensors are never kept for it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .layers import recompute
from .sharding_rules import batch_local, even_placements, on_shards


class GLAState(NamedTuple):
    s: torch.Tensor  # (B, H, Dk, Dv)


def _bcast(x: torch.Tensor, dk: int) -> torch.Tensor:
    """Broadcast a scalar-decay (..., 1) tensor to (..., Dk) lazily."""
    return x.expand(x.shape[:-1] + (dk,)) if x.shape[-1] == 1 else x


def _chunk(s_prev, qi, ki, vi, ldi, u, *, rwkv: bool, scalar_decay: bool,
           pair_bf16: bool):
    """One chunk: (B, C, H, *) inputs and the carried state -> (new state,
    the chunk's readout)."""
    c, dk = ki.shape[1], ki.shape[-1]
    L = torch.cumsum(ldi, dim=1)              # inclusive in-chunk log decay
    Lq = (L - ldi) if rwkv else L             # shift: decay before readout
    Ltot = L[:, -1:]                          # (B,1,H,Dk*)

    # ----- inter-chunk: contribution of the carried state
    q_eff = _bcast(qi * torch.exp(Lq), dk)
    y_inter = torch.einsum("bchk,bhkv->bchv", q_eff, s_prev)

    # ----- intra-chunk
    t_idx = torch.arange(c, device=ki.device)
    mask = (t_idx[:, None] > t_idx[None, :]) if rwkv else (t_idx[:, None] >= t_idx[None, :])
    if scalar_decay:
        # A[t,s] = (q_t . k_s) * exp(Lq_t - L_s): a product times a decay matrix
        dots = torch.einsum("bchk,bshk->bhcs", qi, ki)
        dec = Lq[..., 0].transpose(1, 2)[:, :, :, None] - \
            L[..., 0].transpose(1, 2)[:, :, None, :]           # (B,H,C,C)
        A = dots * torch.exp(torch.where(mask[None, None], dec, -torch.inf))
        A = torch.where(mask[None, None], A, 0.0)
        y_intra = torch.einsum("bhcs,bshv->bchv", A, vi)
    else:
        # per-channel decay: the pairwise (B,C,C,H,Dk) tensor (rwkv6's cost)
        diff = Lq[:, :, None] - L[:, None, :, :]                # t x s
        diff = torch.where(mask[None, :, :, None, None], diff, -torch.inf)
        if pair_bf16:
            # the pairwise tensors in bfloat16 (exp(diff) lives in (0, 1]),
            # contracted in float32 as the reference's preferred_element_type
            # (a product of two bfloat16 values is exact in float32)
            eb = torch.exp(diff.to(torch.bfloat16))
            prod = eb * ki.to(torch.bfloat16)[:, None]          # (B,Ct,Cs,H,Dk)
            A = torch.einsum("bchk,bcshk->bcsh", qi.to(torch.bfloat16).to(qi.dtype),
                             prod.to(qi.dtype))
            y_intra = torch.einsum("bcsh,bshv->bchv", A, vi)
        else:
            A = torch.einsum("bchk,bshk,bcshk->bhcs", qi, ki, torch.exp(diff))
            y_intra = torch.einsum("bhcs,bshv->bchv", A, vi)

    y = y_inter + y_intra
    if rwkv and u is not None:
        # diagonal bonus: y_t += (r_t . (u * k_t)) v_t
        y = y + torch.sum(qi * u * ki, -1, keepdim=True) * vi

    # ----- state update
    k_eff = _bcast(ki * torch.exp(Ltot - L), dk)
    decay_tot = _bcast(torch.exp(Ltot[:, 0]), dk)              # (B,H,Dk)
    s_new = decay_tot[..., None] * s_prev + torch.einsum("bchk,bchv->bhkv", k_eff, vi)
    return s_new, y


def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor, *, u: Optional[torch.Tensor] = None,
                mode: str = "mamba", chunk: int = 64,
                state: Optional[torch.Tensor] = None,
                pair_bf16: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """q,k: (B,S,H,Dk); v: (B,S,H,Dv); log_decay: (B,S,H,Dk) or (B,S,H,1)
    (scalar decay broadcast).  u: (H,Dk) rwkv bonus.  ``state``: the carried
    (B,H,Dk,Dv) state, zeros if None.  Returns (y, final_state); y in q's
    dtype, the state in float32.  Raises ``ValueError`` unless
    ``min(chunk, S)`` divides S."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _on_shards(q, k, v, log_decay, u, state, mode=mode, chunk=chunk,
                          pair_bf16=pair_bf16)
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"chunk {c} does not divide the sequence length {s}")
    f32 = torch.float32

    def wide(x):
        # a head dim broadcast by stride 0 (mamba's shared B and C) stays
        # one: .to() would write every head's copy
        if x.shape[2] > 1 and x.stride(2) == 0:
            return x[:, :, :1].to(f32).expand(x.shape)
        return x.to(f32)

    qf, kf, vf, ld = (wide(x) for x in (q, k, v, log_decay))
    uf = None if u is None else u.to(f32)
    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
    flags = dict(rwkv=mode == "rwkv", scalar_decay=log_decay.shape[-1] == 1,
                 pair_bf16=pair_bf16)

    def body(s_prev, qi, ki, vi, ldi):
        return _chunk(s_prev, qi, ki, vi, ldi, uf, **flags)

    ys = []
    for i in range(s // c):
        part = slice(i * c, (i + 1) * c)
        state, y = recompute(body, state, qf[:, part], kf[:, part], vf[:, part], ld[:, part])
        ys.append(y)
    return torch.cat(ys, dim=1).to(q.dtype), state


def _on_shards(q, k, v, log_decay, u, state, **kw):
    """``chunked_gla`` of DTensors, run on each rank's batch rows and heads:
    the recurrence crosses neither, so its chunk loop needs no
    communication (DTensor would dispatch each of its ops).  Per mesh dim
    of ``q``: batch sharded -> every input's batch (and the state's),
    heads sharded -> every input's heads (``u``'s dim 0, the state's dim
    1), else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    seq, vec, hp, st = [], [], [], []
    for p in even_placements(q):
        if p == Shard(0):
            seq.append(p), vec.append(Replicate()), st.append(Shard(0))
        elif p == Shard(2):
            seq.append(p), vec.append(Shard(0)), st.append(Shard(1))
        else:
            seq.append(Replicate()), vec.append(Replicate()), st.append(Replicate())
    seq, vec, st = tuple(seq), tuple(vec), tuple(st)
    args = [q, k, v, log_decay]
    plc = [seq] * 4
    if u is not None:
        args.append(u), plc.append(vec)
    if state is not None:
        args.append(state), plc.append(st)

    def fn(q, k, v, ld, *rest):
        rest = list(rest)
        uu = rest.pop(0) if u is not None else None
        ss = rest.pop(0) if state is not None else None
        return chunked_gla(q, k, v, ld, u=uu, state=ss, **kw)

    return on_shards(fn, args, plc, (seq, st), mesh)


def gla_decode_step(q, k, v, log_decay, state, *, u=None, mode="mamba"):
    """Single-token recurrence.  q,k: (B,H,Dk); v: (B,H,Dv);
    log_decay: (B,H,Dk) or (B,H,1); state: (B,H,Dk,Dv).  DTensors run on
    each rank's batch rows (``batch_local``: DTensor (torch 2.11) refuses
    the products' flatten of batch x sharded heads)."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        shared = () if u is None else (u,)
        return batch_local(lambda q, k, v, ld, st, *uu: gla_decode_step(
            q, k, v, ld, st, u=uu[0] if uu else None, mode=mode),
            (q, k, v, log_decay, state), shared, n_out=2)
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    d = _bcast(torch.exp(log_decay.to(f32)), kf.shape[-1])
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    if mode == "rwkv":
        bonus = kv * (u.to(f32)[None, :, :, None] if u is not None else 1.0)
        y = torch.einsum("bhk,bhkv->bhv", qf, state + bonus)
        new_state = d[..., None] * state + kv
    else:
        new_state = d[..., None] * state + kv
        y = torch.einsum("bhk,bhkv->bhv", qf, new_state)
    return y.to(q.dtype), new_state
