"""Shared building blocks: norms, RoPE, MLPs, embeddings, softcaps.

Parameters are plain dicts of tensors, the tree the JAX package's
``models/layers.py`` builds, key for key, so
``repro_torch.bridge.params_from_numpy`` carries its parameters across
unchanged.  The arithmetic is the reference's, float32 islands included:
``rms_norm`` takes its mean square and ``rope`` its angles in float32
whatever the model's dtype, as the reference does.

Every init takes, leaf by leaf, the logical :class:`~.sharding_rules.Spec`
the reference gives its ``PartitionSpec``.  One init function builds three
trees, so they match by construction (the reference's ``Boxed``/``unzip``):
a :class:`Maker` draws values, one on the ``meta`` device builds
shape-and-dtype stand-ins (no draw, no allocation), and one made with
``specs=True`` returns each leaf's logical spec.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig

from .sharding_rules import (Spec, _summed, active_rules, dense, even_placements, on_shards,
                             reduced, share)

Params = Dict[str, Any]


BIG_LEAF = 2 ** 31  # elements; such a leaf is drawn a slice of its first axis at a time


class Maker:
    """Creates initialized parameters of ``dtype`` on ``device``, drawing
    from ``generator`` (which must live on ``device``) in call order:
    fan-in normal draws in float32, rounded to ``dtype``.  A leaf of
    BIG_LEAF elements or more (llama4's 128 experts of 5120 x 2 x 8192) is
    drawn slice by slice along its first axis, so its float32 draw is
    never held whole (43 GB there).

    On the ``meta`` device it draws nothing and returns empty stand-ins of
    the leaves' shapes and dtype; with ``specs=True`` it returns each
    leaf's logical spec instead (vocabulary: "model" for tensor
    parallelism, "fsdp" for weight sharding, None replicated; bound to mesh
    axes in ``launch/sharding.py``)."""

    def __init__(self, generator: torch.Generator | None, dtype: torch.dtype,
                 device: torch.device, *, specs: bool = False):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.specs = specs

    @property
    def abstract(self) -> bool:
        return self.specs or self.device.type == "meta"

    def _abstract(self, shape, spec: Spec):
        if self.specs:
            return Spec(*spec)
        return torch.empty(shape, dtype=self.dtype, device="meta")

    def param(self, shape, spec: Spec, scale: float | None = None):
        shape = tuple(shape)
        if self.abstract:
            return self._abstract(shape, spec)
        scale = fan_in_scale(shape) if scale is None else scale
        if len(shape) > 1 and math.prod(shape) >= BIG_LEAF:
            leaf = torch.empty(shape, dtype=self.dtype, device=self.device)
            for i in range(shape[0]):
                leaf[i] = self.param(shape[1:], Spec(*spec[1:]), scale=scale)
            return leaf
        leaf = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                           device=self.device)
        return leaf.mul_(scale).to(self.dtype)

    def zeros(self, shape, spec: Spec):
        if self.abstract:
            return self._abstract(tuple(shape), spec)
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)


def fan_in_scale(shape) -> float:
    """The fan-in normal init's standard deviation for a leaf of ``shape``."""
    return (shape[-2] if len(shape) >= 2 else shape[-1]) ** -0.5


class StackedMaker(Maker):
    """Maker that prepends a layer-group axis to every parameter it creates
    (and a None to its spec), so one init function written for a single
    layer builds the (n_groups, ...) leaves the group loop indexes.  Each
    group's slice is drawn on its own into the stacked leaf (the scale that
    of the stacked shape), so no float32 draw of a whole stacked leaf is
    ever held."""

    def __init__(self, base: Maker, lead: int):
        super().__init__(base.generator, base.dtype, base.device, specs=base.specs)
        self._base = base
        self._lead = lead

    def param(self, shape, spec: Spec, scale: float | None = None):
        full = (self._lead,) + tuple(shape)
        if self.abstract:
            return self._base.param(full, Spec(None, *spec), scale=scale)
        scale = fan_in_scale(full) if scale is None else scale
        leaf = torch.empty(full, dtype=self.dtype, device=self.device)
        for i in range(self._lead):
            leaf[i] = self._base.param(shape, spec, scale=scale)
        return leaf

    def zeros(self, shape, spec: Spec):
        return self._base.zeros((self._lead,) + tuple(shape), Spec(None, *spec))


# logical spec aliases (bound to physical axes in launch/sharding.py)
REPL = Spec()
COL = Spec(None, "model")            # (d_in, d_out/TP)  column-parallel
ROW = Spec("model", None)            # (d_in/TP, d_out)  row-parallel
VOCAB = Spec("model", None)          # embedding table rows over TP


def recompute(fn, *args, when: bool = True):
    """``fn(*args)``, recomputed in the backward instead of saved (the
    reference's ``jax.checkpoint``) when ``when`` holds and autograd
    records."""
    if when and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (x32 * inv).to(dt) * (1.0 + gamma.to(dt))


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integers."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([(x1 * cos - x2 * sin).to(x.dtype),
                      (x2 * cos + x1 * sin).to(x.dtype)], dim=-1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU (the reference's ``approximate=True``)."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# dense FFNs
# ---------------------------------------------------------------------------

def init_mlp_block(mk: Maker, cfg: ArchConfig) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {"wi": mk.param((d, 2, f), Spec(None, None, "model")),  # fused gate+up
                "wo": mk.param((f, d), ROW)}
    if cfg.mlp == "gelu_mlp":
        return {"wi": mk.param((d, f), COL), "wo": mk.param((f, d), ROW)}
    if cfg.mlp == "rwkv_channel_mix":
        return {"mix_k": mk.param((d,), REPL, scale=0.1),
                "wk": mk.param((d, f), COL),
                "wv": mk.param((f, d), ROW),
                "wr": mk.param((d, d), REPL)}
    raise ValueError(cfg.mlp)


def apply_mlp_block(p: Params, cfg: ArchConfig, x: torch.Tensor,
                    x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """``x_prev``: the channel mix's token-shift carry (B, 1, D), the last
    token of the previous segment (decode), or None from a sequence's
    start; the other MLPs ignore it."""
    if cfg.mlp in ("swiglu", "geglu"):
        # the reference's one einsum into (gate, up) as two products: DTensor
        # merges the (2, F) of a d_ff-sharded weight into a strided shard
        gate, up = dense(x, p["wi"][:, 0]), dense(x, p["wi"][:, 1])
        act = F.silu(gate) if cfg.mlp == "swiglu" else gelu(gate)
        return dense(act * up, p["wo"])
    if cfg.mlp == "gelu_mlp":
        return dense(gelu(dense(x, p["wi"])), p["wo"])
    if cfg.mlp == "rwkv_channel_mix":
        # RWKV channel mix: token-shifted key, squared relu, receptance gate
        xk, xr = token_mix(x, x_prev, (p["mix_k"], None))
        k = torch.square(torch.relu(dense(xk, p["wk"])))
        r = torch.sigmoid(dense(xr, p["wr"]))
        return r * reduced(dense(k, p["wv"]))
    raise ValueError(cfg.mlp)


def token_shift(x: torch.Tensor, x_prev: torch.Tensor | None) -> torch.Tensor:
    """RWKV token shift: the previous token's features (zeros, or the
    carried ``x_prev`` (B, 1, D), at t = 0).  x: (B, S, D)."""
    first = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev.to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def token_mix(x: torch.Tensor, x_prev: torch.Tensor | None, mixes: tuple) -> tuple:
    """RWKV's token-shift lerps ``x + (token_shift(x, x_prev) - x) * mix``,
    one a mix of ``mixes`` (None: ``x`` itself).  Where ``x``, ``x_prev``
    and the mixes are DTensors under active rules, they run on the local
    tensors of ``x``'s own layout with their backward stated
    (``_TokenMix``): the lerps are linear in ``x``, so its gradient is
    summed from the outputs' partial gradients and returned partial, to be
    reduced once where the block takes ``x`` in (``entry``); left to
    DTensor, torch 2.11 all-reduces each output's gradient and 2.13 sums
    them partial."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x_prev = None if x_prev is None else x_prev.to(x.dtype)
    tensors = [t for t in (x, x_prev, *mixes) if t is not None]
    if active_rules() is None or not all(isinstance(t, DTensor) for t in tensors):
        xs = token_shift(x, x_prev)
        return tuple(x if m is None else x + (xs - x) * m for m in mixes)
    mesh = x.device_mesh
    plc = _summed(even_placements(x))
    if tuple(x.placements) != plc:
        x = x.redistribute(mesh, plc)
    if x_prev is not None:
        one = tuple(Replicate() if p == Shard(1) else p for p in plc)   # a single token
        if tuple(x_prev.placements) != one:
            x_prev = x_prev.redistribute(mesh, one)
    return _TokenMix.apply(x, x_prev, *mixes)


def _seq_index(mesh, plc: tuple) -> tuple:
    """(this rank's shard of the sequence, the shards) of a tensor laid out
    by ``plc``, in DTensor's order (the first mesh dim major)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    index, n = 0, 1
    for m, p in enumerate(plc):
        if p == Shard(1):
            index, n = index * mesh.size(m) + coord[m], n * mesh.size(m)
    return index, n


def _neighbour(edge: torch.Tensor, mesh, plc: tuple, step: int):
    """The (B, 1, D) ``edge`` of the sequence shard ``step`` away from this
    rank's (-1: the previous, +1: the next), where each rank holds its
    own shard's ``edge`` of a tensor laid out by ``plc``: the edges
    all-gathered over the mesh dims that split the sequence (every rank
    takes part), None past either end or where the sequence is whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    index, n = _seq_index(mesh, plc)
    if n == 1:
        return None
    whole = tuple(Replicate() if p == Shard(1) else p for p in plc)
    edges = DTensor.from_local(edge, mesh, plc, run_check=False).redistribute(mesh, whole)
    j = index + step
    return edges.to_local()[:, j:j + 1] if 0 <= j < n else None


class _TokenMix(torch.autograd.Function):
    """``token_mix`` on the local tensors of ``x`` (split along its batch,
    sequence or channels, nothing partial) and of ``x_prev`` (laid out as
    ``x``, its one token whole), each mix sliced as ``x``'s channels are.
    A split sequence takes the previous shard's last token (``_neighbour``)
    where the shift crosses shards.  The backward takes each output's
    gradient in ``x``'s layout, partial over the mesh dims where ``x`` is
    whole and some output's gradient is partial (``share``), and returns
    ``x``'s gradient so, each mix's reduced onto the mix's own layout."""

    @staticmethod
    def forward(ctx, x, x_prev, *mixes):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh, plc = x.device_mesh, tuple(x.placements)
        ctx.set_materialize_grads(False)
        ctx.mesh, ctx.plc, ctx.dtype = mesh, plc, x.dtype
        ctx.prev = None if x_prev is None else tuple(x_prev.placements)
        ctx.mix_plc = [None if m is None else tuple(m.placements) for m in mixes]
        xl = x.to_local()
        first = _neighbour(xl[:, -1:], mesh, plc, -1)
        if first is None and x_prev is not None:
            first = x_prev.to_local()
        d = token_shift(xl, first) - xl
        by_channel = tuple(Shard(0) if p == Shard(2) else Replicate() for p in plc)
        ml = [None if m is None else m.redistribute(mesh, by_channel).to_local() for m in mixes]
        ctx.save_for_backward(d, *(m for m in ml if m is not None))
        return tuple(DTensor.from_local(xl.view_as(xl) if m is None else xl + d * m, mesh, plc,
                                        run_check=False) for m in ml)

    @staticmethod
    def backward(ctx, *gs):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        mesh, plc = ctx.mesh, ctx.plc
        d, *saved = ctx.saved_tensors
        saved = iter(saved)
        ml = [None if mp is None else next(saved) for mp in ctx.mix_plc]
        target = tuple(Partial() if p == Replicate() and any(
            g is not None and isinstance(g.placements[m], Partial) for g in gs) else p
            for m, p in enumerate(plc))
        # a mix's gradient sums over the rows: partial where they are split
        summed = tuple(Shard(0) if p == Shard(2) else Partial() if isinstance(p, Shard) else p
                       for p in target)
        dx = dxs = None
        dmix = []
        for g, m, mp in zip(gs, ml, ctx.mix_plc):
            g = None if g is None else share(g, target)
            if m is None or g is None:
                dmix.append(None)
                if g is not None:
                    dx = g if dx is None else dx + g
                continue
            gm = g * m
            dx = g - gm if dx is None else dx + (g - gm)
            dxs = gm if dxs is None else dxs + gm
            dm = (g * d).sum_to_size(m.shape).to(m.dtype)
            dmix.append(DTensor.from_local(dm, mesh, summed, run_check=False)
                        .redistribute(mesh, mp))
        dprev = None
        if dxs is not None:
            dx[:, :-1] += dxs[:, 1:]
            after = _neighbour(dxs[:, :1], mesh, target, +1)
            if after is not None:
                dx[:, -1:] += after
            if ctx.prev is not None:
                # the carry's gradient: the first shard's first token, partial
                # over the mesh dims that split the sequence
                first = _seq_index(mesh, target)[0] == 0
                mine = dxs[:, :1] if first else torch.zeros_like(dxs[:, :1])
                one = tuple(Partial() if p == Shard(1) else p for p in target)
                dprev = DTensor.from_local(mine, mesh, one, run_check=False)
        if dx is not None:
            dx = DTensor.from_local(dx.to(ctx.dtype), mesh, target, run_check=False)
        return (dx, dprev, *dmix)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def init_embed(mk: Maker, cfg: ArchConfig) -> Params:
    p = {"table": mk.param((cfg.vocab, cfg.d_model), VOCAB, scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        p["lm_head"] = mk.param((cfg.d_model, cfg.vocab), COL)
    return p


def _rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table's rows are gathered on each
    rank's slice of the vocabulary, a token outside it giving zeros, and
    summed over the vocabulary's mesh dims (exact: one rank holds each
    row); DTensor (torch 2.11) has no rule for a gather by tokens sharded
    over two mesh dims, nor for the gather's backward."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    tp = even_placements(table)
    kp = even_placements(tokens) if isinstance(tokens, DTensor) else (Replicate(),) * mesh.ndim
    coord = mesh.get_coordinate()
    pt, pk, po, idx, n = [], [], [], 0, 1
    for m in range(mesh.ndim):
        if tp[m] == Shard(0):
            idx, n = idx * mesh.size(m) + coord[m], n * mesh.size(m)
            pt.append(Shard(0)), pk.append(Replicate()), po.append(Partial())
        elif kp[m] == Shard(0):
            pt.append(Replicate()), pk.append(Shard(0)), po.append(Shard(0))
        else:
            pt.append(Replicate()), pk.append(Replicate()), po.append(Replicate())
    v0 = idx * (table.shape[0] // n)

    def gather(t, k):
        rows = k - v0
        inside = (rows >= 0) & (rows < t.shape[0])
        return t[rows.clamp(0, t.shape[0] - 1)] * inside[..., None].to(t.dtype)

    return on_shards(gather, (table, tokens), (tuple(pt), tuple(pk)), po, mesh)


def embed(p: Params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = _rows(p["table"], tokens)
    # the scale rounded to the table's dtype first, as the reference does
    return x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)


def logits(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = dense(x, p["table"].t())
    else:
        out = dense(x, p["lm_head"])
    return softcap(out, cfg.logit_softcap)
