"""Mixture-of-Experts with sort-based capacity dispatch (MegaBlocks-style).

No (tokens x experts x capacity) one-hot is ever materialized.  Instead:

  1. top-k routing per token (renormalized softmax over the selected k);
  2. a stable argsort of the (N*k) slot -> expert assignments;
  3. rank within expert from the exclusive cumulative counts; slots with
     rank >= capacity drop (they go to a trash row, standard
     capacity-factor semantics);
  4. scatter tokens into an (E*C, D) buffer, one dense product per expert,
     gather back with the combine weights.

The auxiliary load-balance loss is the standard Switch formulation.

The JAX package's ``models/moe.py`` op for op, its float32 router
included, with three places where a torch spelling could change the
numbers and does not here: the argsort is stable (``jnp.argsort`` is),
so the tokens a binding capacity drops are the reference's; the trash row
is a real spare row of the buffer, written and never read (the reference's
``mode="drop"`` scatter), and the gather reads zeros there (its
``mode="fill"``); the index is never clamped.  The combine's scatter-add is
``index_add_``, whose order of summation on CUDA is not fixed (atomics):
on the card the output equals the reference's to rounding, not bit for bit
(a token's k <= 2 contributions are its only summands).

Expert placement (logical specs, bound in launch/):
  * E >= 16 (llama4: 128): expert-parallel -- E sharded over "model";
  * E <  16 (mixtral: 8):  tensor-parallel inside each expert -- d_ff
    sharded over "model" (E stays replicated).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

from .layers import Maker, Params
from .sharding_rules import (Spec, active_rules, batch_local, even_placements, local, on_shards,
                             reduced, shard)

EP_MIN_EXPERTS = 16  # model-axis size on both production meshes
DISPATCH_GROUPS = 32  # the reference's pod x data shards; local dispatch per group


def init_moe(mk: Maker, cfg: ArchConfig) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    if e >= EP_MIN_EXPERTS:  # expert parallel
        wi_spec, wo_spec = Spec("model", None, None, None), Spec("model", None, None)
    else:                    # TP within experts
        wi_spec, wo_spec = Spec(None, None, None, "model"), Spec(None, "model", None)
    return {
        "router": mk.param((d, e), Spec(None, None), scale=d ** -0.5),
        "wi": mk.param((e, d, 2, f), wi_spec),
        "wo": mk.param((e, f, d), wo_spec),
    }


def dispatch_geometry(cfg: ArchConfig, n: int, training: bool) -> tuple[int, int, int]:
    """(groups, tokens a group, capacity an expert) for ``n`` tokens:
    DISPATCH_GROUPS halved until it divides ``n``; with ``training`` the
    capacity ceil(n_loc k / E x capacity_factor) clipped to [1, n_loc],
    else dropless (n_loc, the most an expert can receive, since a token's
    top-k experts are distinct)."""
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    g = DISPATCH_GROUPS
    while n % g:
        g //= 2
    n_loc = n // g
    if training:
        cap = max(1, min(int(math.ceil(n_loc * k / e * cfg.moe.capacity_factor)), n_loc))
    else:
        cap = n_loc
    return g, n_loc, cap


def _dispatch(xf: torch.Tensor, top_e: torch.Tensor, e: int, cap: int, lo: int, n: int):
    """Per group: the (N_loc*k) slots sorted by expert (stable), ranked
    within their expert from the exclusive cumulative counts, and packed
    into the (G, n, cap, D) buffer of experts ``lo`` to ``lo + n`` of the
    ``e`` (all of them, or under expert parallelism the rank's own, so no
    rank holds the whole buffer); a slot ranked past ``cap``, or of
    another rank's expert, goes to the trash row.  Returns (h_in, slot,
    stok, order, keep), each led by the group axis: no group reads
    another's rows."""
    g, n_loc, d = xf.shape
    k = top_e.shape[-1]
    flat_e = top_e.reshape(g, n_loc * k)
    flat_tok = torch.arange(n_loc, device=xf.device).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = flat_tok[order]                                      # (G, N_loc*k)
    counts = torch.zeros((g, e), dtype=flat_e.dtype, device=xf.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=1) - counts              # exclusive
    rank = torch.arange(n_loc * k, device=xf.device) - torch.gather(offsets, 1, se)
    keep = rank < cap
    mine = keep & (se >= lo) & (se < lo + n)
    slot = torch.where(mine, (se - lo) * cap + rank, n * cap)   # n*cap: the trash row
    rows = torch.arange(g, device=xf.device)[:, None]
    buf = xf.new_zeros((g, n * cap + 1, d))
    buf[rows, slot] = xf[rows, stok]
    return buf[:, :n * cap].reshape(g, n, cap, d), slot, stok, order, keep


def _combine(h_out: torch.Tensor, slot: torch.Tensor, stok: torch.Tensor,
             order: torch.Tensor, keep: torch.Tensor, top_w: torch.Tensor,
             n_loc: int) -> torch.Tensor:
    """Per group: each slot's expert output (zeros from the trash row)
    times its kept weight, summed into its token's row: (G, n, cap, D) ->
    (G, N_loc, D); under expert parallelism the rank's share of the sum
    (its experts' slots)."""
    g, n, cap, d = h_out.shape
    sw = torch.gather(top_w.reshape(g, -1), 1, order) * keep
    rows = torch.arange(g, device=h_out.device)[:, None]
    out_buf = torch.cat([h_out.reshape(g, n * cap, d), h_out.new_zeros((g, 1, d))], dim=1)
    gathered = out_buf[rows, slot] * sw.to(out_buf.dtype)[..., None]
    y = h_out.new_zeros((g * n_loc, d))
    y.index_add_(0, (rows * n_loc + stok).reshape(-1), gathered.reshape(-1, d))
    return y.reshape(g, n_loc, d)


def group_mean(t: torch.Tensor) -> torch.Tensor:
    """``t.mean((0, 1))`` of a (G, N, E) tensor.  Where ``t`` is a DTensor
    under active rules, each rank sums its own rows and the (E,) sum is
    reduced once over the mesh dims that split them; the backward expands
    the (E,) gradient onto each rank's own rows (``_GroupMean``).  Left to
    DTensor, torch 2.13 keeps the mean partial, and its backward
    reduce-scatters the gradient at (G, N, E) where torch 2.11 reduces the
    (E,) vector."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if active_rules() is None or not isinstance(t, DTensor):
        return t.mean((0, 1))
    rows = tuple(p if p == Shard(0) else Replicate() for p in even_placements(t))
    if tuple(t.placements) != rows:
        t = t.redistribute(t.device_mesh, rows)
    return _GroupMean.apply(t)


class _GroupMean(torch.autograd.Function):
    """``group_mean`` of a DTensor split by its leading rows at most."""

    @staticmethod
    def forward(ctx, t):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        mesh, plc = t.device_mesh, tuple(t.placements)
        ctx.mesh, ctx.plc, ctx.shape = mesh, plc, t.to_local().shape
        ctx.count = t.shape[0] * t.shape[1]
        part = tuple(Replicate() if p == Replicate() else Partial() for p in plc)
        total = DTensor.from_local(t.to_local().sum((0, 1)), mesh, part, run_check=False)
        return total.redistribute(mesh, (Replicate(),) * mesh.ndim) / ctx.count

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate
        g = g.redistribute(ctx.mesh, (Replicate(),) * ctx.mesh.ndim).to_local() / ctx.count
        return DTensor.from_local(g.expand(ctx.shape), ctx.mesh, ctx.plc, run_check=False)


def _top_k(probs: torch.Tensor, k: int):
    """(weights renormalized over the selected k, experts) of each token's
    k largest ``probs``, in descending order."""
    top_w, top_e = torch.topk(probs, k, dim=-1, sorted=True)
    return top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9), top_e


def _ffn(h_in, wi, wo):
    """Every expert's SwiGLU on its (G, E, cap, D) buffer: the reference's
    one einsum into (gate, up) as two products."""
    gate = torch.einsum("gecd,edf->gecf", h_in, wi[:, :, 0])
    up = torch.einsum("gecd,edf->gecf", h_in, wi[:, :, 1])
    return torch.einsum("gecf,efd->gecd", F.silu(gate) * up, wo)


def _experts(h_in, wi, wo):
    """``_ffn`` on each rank's shards where the buffer is a DTensor
    (DTensor's own products view their local tensors where the strides
    forbid it once FSDP splits the experts' weights).  Per mesh dim:
    experts split (expert parallel) -> the buffer's expert dim alike; the
    groups split -> the weights gathered (FSDP, whichever of their dims it
    splits), the output's groups split alike; d_ff split with the groups
    whole (tensor parallel, or FSDP's split of llama4's d_ff over "data")
    -> the buffer whole, the output partial; else all whole.  Where the
    groups and d_ff are both split, whichever of the buffer and the
    weights is smaller on the rank is gathered: the weights in a prefill
    (llama4's buffer 40 GiB a group, its experts' weights 1.3 GB), the
    buffer at decode (a few tokens an expert)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(h_in, DTensor):
        return _ffn(h_in, wi, wo)
    small = h_in.to_local().numel() < wi.to_local().numel() + wo.to_local().numel()
    ph, pi, po, out = [], [], [], []
    for p, q, r in zip(even_placements(h_in), even_placements(wi), even_placements(wo)):
        d_ff = q == Shard(3) and r == Shard(1)
        if q == Shard(0) and r == Shard(0):
            ph.append(Shard(1)), pi.append(q), po.append(r), out.append(Shard(1))
        elif p == Shard(0) and not (d_ff and small):
            ph.append(p), pi.append(Replicate()), po.append(Replicate()), out.append(p)
        elif d_ff:
            ph.append(Replicate()), pi.append(q), po.append(r), out.append(Partial())
        else:
            ph.append(Replicate()), pi.append(Replicate()), po.append(Replicate())
            out.append(Replicate())
    return on_shards(_ffn, (h_in, wi, wo), (tuple(ph), tuple(pi), tuple(po)), out,
                     h_in.device_mesh)


def expert_slice(x, e: int) -> tuple[int, int]:
    """(first expert, experts) of this rank's share of the dispatch buffer
    where ``x`` is a DTensor and the experts are split over the active
    rules' "model" axes (expert parallelism): the experts its shard of the
    experts' weights holds.  Else, or where the axes do not divide ``e``,
    (0, e): every expert."""
    from torch.distributed.tensor import DTensor
    rules = active_rules()
    if rules is None or not isinstance(x, DTensor):
        return 0, e
    mesh = x.device_mesh
    ranks, index = 1, 0
    for name in rules.model:
        size = mesh.size(mesh.mesh_dim_names.index(name))
        ranks, index = ranks * size, index * size + mesh.get_local_rank(name)
    if e % ranks:
        return 0, e
    return index * (e // ranks), e // ranks


def apply_moe(p: Params, cfg: ArchConfig, x: torch.Tensor,
              training: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).

    Dispatch is group-local: the tokens split into ``dispatch_geometry``'s
    groups, and each routes and packs its own (E, cap) buffer.  Under a
    mesh the groups are sharded like the batch, and the dispatch and the
    combine run on each rank's groups (``sharding_rules.local``: DTensor
    has no strategy for the sort, the scatter into the trash row or
    ``index_add_``).  Under expert parallelism (the experts split over
    "model") each rank packs and combines only its own experts' slots
    (``expert_slice``), so no rank holds a whole (E, cap) buffer, and the
    combine's per-rank sums are reduced over "model": only the routed
    tokens' rows and that sum move between ranks.

    Capacity-factor drops are *training-only* load shaping: with
    ``training=False`` (inference: full forward, prefill, decode) dispatch
    is dropless, so the logits of a sequence routed jointly are those of
    the same tokens decoded one at a time."""
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    n = b * s
    g, n_loc, cap = dispatch_geometry(cfg, n, training)
    f32 = torch.float32
    ep = "model" if e >= EP_MIN_EXPERTS else None

    xf = shard(x.reshape(g, n_loc, d), "batch", None, None)
    gates = torch.einsum("gnd,de->gne", xf.to(f32), p["router"].to(f32))
    probs = torch.softmax(gates, dim=-1)
    # the top-k on each rank's groups, its gradient's layout stated (left
    # to DTensor, torch 2.11 gathers the groups' indices in the backward)
    top_w, top_e = batch_local(lambda p: _top_k(p, k), (probs,), n_out=2)  # (G,N_loc,k)

    # ---- aux loss (Switch): E * sum_e f_e * P_e (global averages); the
    # counts by comparison, each rank's summed and reduced as integers (exact)
    me = group_mean(probs)
    hits = top_e[..., None] == torch.arange(e, device=x.device)
    ce = reduced(hits.sum((0, 1, 2))).to(f32) / (n * k)
    aux = e * torch.sum(me * ce)

    # logical specs of the group-led tensors the local steps exchange; the
    # dispatch packs each rank's experts alone, and the combine's output
    # is each rank's share of the sum over them
    lo, n_e = expert_slice(xf, e) if ep else (0, e)
    ep = ep if n_e < e else None
    g3, g2, g4 = Spec("batch", None, None), Spec("batch", None), Spec("batch", ep, None, None)
    h_in, slot, stok, order, keep = local(lambda xf, te: _dispatch(xf, te, e, cap, lo, n_e),
                                          (g4, g2, g2, g2, g2), (g3, g3))(xf, top_e)

    h_out = shard(_experts(h_in, p["wi"], p["wo"]), "batch", ep, None, None)

    y = local(lambda ho, sl, st, o, kp, tw: _combine(ho, sl, st, o, kp, tw, n_loc), g3,
              (g4, g2, g2, g2, g2, g3), partial=ep)(h_out, slot, stok, order, keep, top_w)
    y = shard(y, "batch", None, None)
    return y.reshape(b, s, d).to(x.dtype), aux
