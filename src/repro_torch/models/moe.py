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

The reference's sharding specs and ``shard()`` hints, and its choice of
expert- or tensor-parallel placement (``EP_MIN_EXPERTS``), have no meaning
on one card and are left out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

from .layers import Maker, Params

DISPATCH_GROUPS = 32  # the reference's pod x data shards; local dispatch per group


def init_moe(mk: Maker, cfg: ArchConfig) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "router": mk.param((d, e), scale=d ** -0.5),
        "wi": mk.param((e, d, 2, f)),
        "wo": mk.param((e, f, d)),
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


def apply_moe(p: Params, cfg: ArchConfig, x: torch.Tensor,
              training: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).

    Dispatch is group-local: the tokens split into ``dispatch_geometry``'s
    groups, and each routes and packs its own (E, cap) buffer.

    Capacity-factor drops are *training-only* load shaping: with
    ``training=False`` (inference: full forward, prefill, decode) dispatch
    is dropless, so the logits of a sequence routed jointly are those of
    the same tokens decoded one at a time."""
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    n = b * s
    g, n_loc, cap = dispatch_geometry(cfg, n, training)
    f32 = torch.float32

    xf = x.reshape(g, n_loc, d)
    gates = torch.einsum("gnd,de->gne", xf.to(f32), p["router"].to(f32))
    probs = torch.softmax(gates, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1, sorted=True)   # (G,N_loc,k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # ---- aux loss (Switch): E * sum_e f_e * P_e (global averages)
    me = probs.mean((0, 1))
    ce = torch.bincount(top_e.reshape(-1), minlength=e).to(f32) / (n * k)
    aux = e * torch.sum(me * ce)

    # ---- dispatch: per group, slots sorted by expert (stable), ranked
    flat_e = top_e.reshape(g, n_loc * k)
    flat_w = top_w.reshape(g, n_loc * k)
    flat_tok = torch.arange(n_loc, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    sw = torch.gather(flat_w, 1, order)
    stok = flat_tok[order]                                      # (G, N_loc*k)
    counts = torch.zeros((g, e), dtype=flat_e.dtype, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=1) - counts              # exclusive
    rank = torch.arange(n_loc * k, device=x.device) - torch.gather(offsets, 1, se)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)          # e*cap: the trash row
    rows = torch.arange(g, device=x.device)[:, None]
    buf = x.new_zeros((g, e * cap + 1, d))
    buf[rows, slot] = xf[rows, stok]
    h_in = buf[:, :e * cap].reshape(g, e, cap, d)

    gu = torch.einsum("gecd,edtf->gectf", h_in, p["wi"])
    act = F.silu(gu[..., 0, :]) * gu[..., 1, :]
    h_out = torch.einsum("gecf,efd->gecd", act, p["wo"])

    # ---- combine: the trash row reads zeros
    out_buf = torch.cat([h_out.reshape(g, e * cap, d), h_out.new_zeros((g, 1, d))], dim=1)
    gathered = out_buf[rows, slot] * (sw * keep).to(out_buf.dtype)[..., None]
    y = h_out.new_zeros((g * n_loc, d))
    y.index_add_(0, (rows * n_loc + stok).reshape(-1), gathered.reshape(-1, d))
    return y.reshape(b, s, d).to(x.dtype), aux
