"""Logical-axis sharding on torch device meshes, mesh-agnostic.

Model code annotates activations with *logical* axis names ("batch",
"model", "seq", None); the launcher activates a ``Rules`` binding that maps
them to the axes of a ``torch.distributed.device_mesh.DeviceMesh`` (named
"pod", "data", "model", "stage", as the JAX package names its mesh axes).
With no active rules, or on a plain tensor, every annotation is a no-op, so
the same model runs un-meshed and on the single-pod (data, model) and
multi-pod (pod, data, model) meshes unchanged.

The JAX package's GSPMD sharding maps onto DTensor as follows: a logical
``PartitionSpec`` (here :class:`Spec`, one entry per tensor dim) becomes
one placement per mesh dim (:func:`placements`: ``Shard(d)`` where tensor
dim ``d`` names that mesh axis, else ``Replicate()``);
``with_sharding_constraint`` becomes ``DTensor.redistribute`` (:func:`shard`);
``in_shardings`` becomes ``distribute_tensor`` (``launch/sharding.py``); the
collectives GSPMD inserts are those DTensor's propagation inserts.

Physical binding used by launch/:
  batch -> (pod, data) | (data,)     seq -> (data,) when SP is on
  model -> (model,)                  fsdp -> (data,) for >=20B params

``make_rules`` and ``bind_pspec`` read only the axis names and sizes, so they
take a plain ``{name: size}`` mapping as well as a ``DeviceMesh``: the
production meshes can be planned without their 256 ranks.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch


class Spec(tuple):
    """A logical or bound partition spec: one entry per leading tensor dim
    (None, an axis name, or a tuple of axis names); dims past its end are
    replicated.  The port's stand-in for ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"

    def __getnewargs__(self):
        return tuple(self)


def spec_map(fn: Callable, specs, *rest):
    """``fn(spec, *leaves)`` over a tree whose leaves are :class:`Spec`
    (dicts, lists, tuples and NamedTuples as nodes) and trees of the same
    structure; returns the tree of results."""
    if isinstance(specs, Spec):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: spec_map(fn, v, *(r[k] for r in rest)) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        out = [spec_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(specs)]
        return type(specs)(*out) if hasattr(specs, "_fields") else type(specs)(out)
    raise TypeError(f"unsupported spec tree node {type(specs).__name__}")


def spec_leaves(specs) -> List[Spec]:
    """The :class:`Spec` leaves of ``specs`` in ``jax.tree_util`` order
    (dict entries by sorted key)."""
    if isinstance(specs, Spec):
        return [specs]
    if isinstance(specs, dict):
        return [leaf for k in sorted(specs) for leaf in spec_leaves(specs[k])]
    return [leaf for v in specs for leaf in spec_leaves(v)]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping standing in
    for one (in the mesh's dim order)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclass(frozen=True)
class Rules:
    batch: Tuple[str, ...] = ()
    model: Tuple[str, ...] = ()
    seq: Tuple[str, ...] = ()
    fsdp: Tuple[str, ...] = ()

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        axes = getattr(self, logical)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes


_ACTIVE: Optional[Rules] = None


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, rules
    try:
        yield
    finally:
        _ACTIVE = prev


def active_rules() -> Optional[Rules]:
    return _ACTIVE


def make_rules(mesh, *, sp: bool = False, fsdp: bool = False,
               policy: str = "tp") -> Rules:
    """policy="tp": the model axis does tensor parallelism (default).
    policy="dp": the model axis joins the batch axes -- pure data
    parallelism for models small enough to replicate (qwen3-0.6b).
    ``mesh``: a ``DeviceMesh``, a ``{name: size}`` mapping, or None."""
    if mesh is None:
        return Rules()
    names = tuple(axis_sizes(mesh))
    if policy == "dp":
        return Rules(
            batch=tuple(a for a in ("pod", "data", "model") if a in names),
            model=(),
            seq=(),
            fsdp=("data",) if (fsdp and "data" in names) else (),
        )
    return Rules(
        batch=tuple(a for a in ("pod", "data") if a in names),
        model=tuple(a for a in ("model",) if a in names),
        seq=("data",) if (sp and "data" in names) else (),
        fsdp=("data",) if (fsdp and "data" in names) else (),
    )


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of a *bound* spec on ``mesh`` (a ``DeviceMesh``
    or a mapping in its dim order): per mesh dim, ``Shard(d)`` where tensor
    dim ``d`` names that axis, else ``Replicate()``.  A dim bound to several
    axes keeps JAX's layout, the shard index running over the axes in the
    entry's order (major first); DTensor splits a dim over its mesh dims in
    mesh order, so an entry whose axes are out of mesh order is refused.
    An axis of size 1 shards nothing and places ``Replicate()``: DTensor
    (torch 2.11) refuses to flatten a dim "sharded" over it into another,
    as the attention's products do."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    names = list(sizes)
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"spec entry {entry!r} lists mesh axes out of the mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner and sizes[a] > 1 else Replicate()
                 for a in names)


def _axes(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def fitted(spec: Spec, shape, mesh) -> Spec:
    """``spec`` with every entry whose dim does not divide its axes' size
    dropped (left unsharded), as ``launch.sharding.sanitize_spec`` does for
    the bound specs: DTensor shards an uneven dim, but a later reshape of it
    raises, and the reference's GSPMD pads where DTensor would not."""
    sizes = axis_sizes(mesh)
    out = []
    for d, entry in enumerate(spec):
        n = 1
        for a in _axes(entry):
            n *= sizes.get(a, 1)
        out.append(entry if d < len(shape) and shape[d] % n == 0 else None)
    return Spec(*out)


def shard(x, *logical):
    """Constrain ``x`` to logical axes ("batch"/"model"/"seq"/None per dim):
    ``x`` redistributed to the bound placements on its own mesh, a dim that
    does not divide its axes left unsharded (``fitted``).  A no-op when no
    rules are active or ``x`` is not a DTensor."""
    if _ACTIVE is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = fitted(Spec(*(_ACTIVE.resolve(a) for a in logical)), x.shape, x.device_mesh)
    target = placements(spec, x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def on_shards(fn, args, in_placements, out_placements, mesh):
    """``fn`` run on the local tensors of ``args`` redistributed to
    ``in_placements`` (one tuple an argument), its outputs wrapped with
    ``out_placements`` (a list for one output, a tuple of tuples for
    several; None for an argument that is no tensor): ``local_map``, with
    the gradients' layout stated.  An input
    replicated over a mesh dim along which an output is split (sharded or
    partial) gets its gradient partial there -- each rank's share of the
    work adds to it -- where ``local_map`` would take it as replicated, and
    drop every rank's share but its own."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    outs = [out_placements] if isinstance(out_placements, list) else list(out_placements)
    split = [any(o[m] != Replicate() for o in outs) for m in range(mesh.ndim)]
    grads = tuple(None if plc is None else
                  tuple(Partial() if split[m] and p == Replicate() else p
                        for m, p in enumerate(plc)) for plc in in_placements)
    return local_map(fn, out_placements=out_placements, in_placements=tuple(in_placements),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def batch_local(fn, batched: tuple, shared: tuple = (), n_out: int = 1):
    """``fn(*batched, *shared)`` on each rank's rows of the batch-led
    ``batched`` tensors (their leading dim, as the first of them is split;
    everything else gathered), ``shared`` gathered whole, its ``n_out``
    outputs batch-led alike: for a computation no op of which crosses a
    batch row, where DTensor (torch 2.11) fails on its pads and flattened
    dims.  ``fn`` itself without a DTensor among ``batched``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    lead = batched[0]
    if not isinstance(lead, DTensor):
        return fn(*batched, *shared)
    mesh = lead.device_mesh
    rows = tuple(p if p == Shard(0) else Replicate() for p in even_placements(lead))
    whole = (Replicate(),) * mesh.ndim
    outs = list(rows) if n_out == 1 else (rows,) * n_out
    return on_shards(fn, batched + shared, (rows,) * len(batched) + (whole,) * len(shared),
                     outs, mesh)


def even_placements(t) -> tuple:
    """A DTensor's placements, each ``Shard`` of a dim that its mesh dims
    do not divide evenly replaced by ``Replicate()``: what a function run on
    each rank's shards (``local_map``) may take, since it wraps its outputs
    as even shards (DTensor's own strategies shard unevenly: llama4's 40
    heads over 16 ranks)."""
    from torch.distributed.tensor import Replicate, Shard
    plc = list(t.placements)
    for d in range(t.ndim):
        mdims = [m for m, p in enumerate(plc) if p == Shard(d)]
        n = 1
        for m in mdims:
            n *= t.device_mesh.size(m)
        if t.shape[d] % n:
            for m in mdims:
                plc[m] = Replicate()
    return tuple(plc)


def dense(x, w):
    """``x @ w`` for (..., K) activations and a (K, N) weight, where they
    are DTensors laid out as a tensor-parallel product.  Per mesh dim: a
    column-sharded ``w`` (Shard(1)) on a tensor-parallel axis (the active
    rules' "model"), or on any axis that does not split ``x``'s rows,
    makes the output's columns sharded and ``x`` gathered (Megatron's
    sequence-parallel gather); a row-sharded one (Shard(0)) against ``x``
    sharded along K, or against ``x`` not split there at all on a
    tensor-parallel axis or, on another (FSDP's), where ``x`` has no more
    rows than K (``x``'s slice along K taken: a local chunk; a decode
    token's partial output moves less than the gathered weight would),
    makes the output partial (row parallel); where ``x``'s rows are split,
    ``w`` is gathered (FSDP: the weight all-gathered at use) and the
    output's rows split alike; else both are gathered.  GSPMD's choices for these products, taken here rather than
    searched: DTensor's own search over a product's strategies on the
    three-dim mesh takes minutes a product (torch 2.13), and the layout
    its propagation hands a product differs between torch versions, which
    the rule must not follow (a replicated ``x`` against a row-sharded
    ``w`` gathered the weight on torch 2.11)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor) or not isinstance(w, DTensor):
        return x @ w
    k = x.ndim - 1
    mesh = x.device_mesh
    tp = set(_ACTIVE.model) if _ACTIVE is not None else set()
    few_rows = math.prod(x.shape[:-1]) <= x.shape[-1]
    px, pw, po = [], [], []
    for name, p, q in zip(mesh.mesh_dim_names, even_placements(x), even_placements(w)):
        rows = isinstance(p, Shard) and p.dim < k
        if q == Shard(1) and (name in tp or not rows):
            px.append(Replicate()), pw.append(q), po.append(Shard(k))
        elif q == Shard(0) and (p == Shard(k) or (not isinstance(p, Shard)
                                                  and (name in tp or few_rows))):
            px.append(Shard(k)), pw.append(q), po.append(Partial())
        elif rows:
            px.append(p), pw.append(Replicate()), po.append(p)
        else:
            px.append(Replicate()), pw.append(Replicate()), po.append(Replicate())
    return on_shards(torch.matmul, (x, w), (tuple(px), tuple(pw)), po, mesh)


def _summed(placements) -> tuple:
    """``placements`` with each ``Partial()`` reduced to ``Replicate()``."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Replicate() if isinstance(p, Partial) else p for p in placements)


def reduced(x):
    """``x`` with each partial placement reduced (all-reduced to
    ``Replicate()``); ``x`` itself where nothing is partial or it is no
    DTensor.  For a partial sum whose consumers need whole values: left
    partial, DTensor's propagation picks where and how it is reduced, and
    torch 2.11 and 2.13 pick differently (2.13 reduce-scatters partial
    attention scores that it then gathers back)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or _summed(x.placements) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, _summed(x.placements))


def gathered(t):
    """``t`` replicated over every mesh dim (itself without active rules):
    a small parameter sharded over "model" (a per-head or per-channel
    vector) all-gathered before it meets an activation that is whole over
    "model".  Left to DTensor, torch 2.13 splits the activation
    instead and gathers its results back later (gigabytes a layer in
    zamba2's mamba blocks, where 2.11 gathers the vector)."""
    from torch.distributed.tensor import DTensor, Replicate
    if _ACTIVE is None or not isinstance(t, DTensor):
        return t
    target = (Replicate(),) * t.device_mesh.ndim
    return t if tuple(t.placements) == target else t.redistribute(t.device_mesh, target)


class _Entry(torch.autograd.Function):
    """Identity forward; the gradient reduced onto the input's layout."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        target = _summed(ctx.placements)
        if isinstance(g, DTensor) and tuple(g.placements) != target:
            g = g.redistribute(ctx.mesh, target)
        return g


def share(g, target) -> torch.Tensor:
    """The local tensor of the DTensor ``g`` laid out by ``target``.  On a
    mesh dim where ``g`` is whole and ``target`` partial, this rank's share
    of the sum: the whole on the dim's coordinate 0, zeros on the others
    (exact, and nothing moves; DTensor's own conversion divides by the
    dim's size); any other difference redistributed."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    plc, mine = list(g.placements), True
    for m, (p, q) in enumerate(zip(plc, target)):
        if isinstance(q, Partial) and p == Replicate():
            plc[m], mine = q, mine and g.device_mesh.get_coordinate()[m] == 0
    t = g.to_local() if mine else torch.zeros_like(g.to_local())
    if tuple(plc) == tuple(target):
        return t
    g = DTensor.from_local(t, g.device_mesh, plc, run_check=False)
    return g.redistribute(g.device_mesh, tuple(target)).to_local()


def entry(x):
    """``x`` as a block takes it in (a normed residual, the encoder's
    output): the identity, whose gradient -- the sum of the partial shares
    of the block's products that split their work over mesh dims where
    ``x`` is whole -- is reduced here, once, onto ``x``'s own layout
    (Megatron's conjugate of the block output's reduction, ``residual``).
    Left to DTensor, torch 2.11 all-reduces each product's share and 2.13
    reduce-scatters some of them."""
    from torch.distributed.tensor import DTensor
    if _ACTIVE is None or not isinstance(x, DTensor):
        return x
    return _Entry.apply(x)


def residual(x, y):
    """``x + y`` for a residual stream ``x`` and a block's output ``y``.
    Where both are DTensors, a partial ``x`` is reduced and ``y`` is laid
    out as ``x`` before the sum: a partial ``y`` (a row-parallel product's)
    is reduced once, onto ``x``'s layout -- an all-reduce where ``x`` is
    replicated, a reduce-scatter where it is split.  GSPMD's choice for
    the sum, taken here because DTensor's differs by torch version: torch
    2.11 reduces ``y`` before the sum, 2.13 makes ``x`` partial and leaves
    the sum partial, so that each of its consumers reduces it again (the
    float32 square in ``rms_norm`` all-reduced twice)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or not isinstance(y, DTensor):
        return x + y
    x = reduced(x)
    if tuple(y.placements) != tuple(x.placements):
        y = y.redistribute(x.device_mesh, x.placements)
    return x + y


def split_dim(x, dim: int, sizes: tuple):
    """``x`` with dim ``dim`` split into ``sizes`` (a reshape).  A DTensor
    whose dim is sharded over mesh dims that the leading size does not
    divide is first replicated over them: DTensor refuses to split an
    uneven shard (rwkv6's 40 heads of a 16-way sharded width)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dim = dim % x.ndim
    if isinstance(x, DTensor):
        plc = tuple(x.placements)
        n = 1
        for m, p in enumerate(plc):
            if p == Shard(dim):
                n *= x.device_mesh.size(m)
        if sizes[0] % n:
            x = x.redistribute(x.device_mesh,
                               tuple(Replicate() if p == Shard(dim) else p for p in plc))
    return x.reshape(x.shape[:dim] + tuple(sizes) + x.shape[dim + 1:])


def bind_pspec(spec: Spec, rules: Rules) -> Spec:
    """Bind a *logical* parameter spec ("model"/"fsdp" entries) to physical
    axes; drops axes the mesh doesn't have."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        entries = entry if isinstance(entry, tuple) else (entry,)
        phys = []
        for e in entries:
            r = rules.resolve(e) if e in ("model", "fsdp", "batch", "seq") else e
            if r is None:
                continue
            phys.extend(r if isinstance(r, tuple) else (r,))
        out.append(tuple(phys) if len(phys) > 1 else (phys[0] if phys else None))
    return Spec(*out)


def local(fn: Callable, out_specs, in_specs, partial: Optional[str] = None) -> Callable:
    """``fn`` run on each rank's shards where DTensor has no sharding
    strategy for its ops (``torch.distributed.tensor.experimental.
    local_map``): its DTensor arguments are redistributed to the logical
    ``in_specs`` (one per argument, None for a non-tensor) bound by the
    active rules, ``fn`` sees their local tensors, and its outputs are
    wrapped with the bound ``out_specs`` (one spec, or a tuple of specs for
    a tuple of outputs); with ``partial`` (a logical axis), the outputs are
    each rank's share of a sum over that axis's mesh dims (``Partial()``
    there).  A logical axis whose dim does not divide in some
    argument (``fitted``: a batch of 1 against 16 data ranks) is dropped
    from every in and out spec, so each rank runs ``fn`` on the whole of
    that dim.  Without active rules, or without a DTensor argument, it is
    ``fn`` itself.  ``fn`` must be local: it may read no row of another
    rank's shard."""

    def run(*args):
        from torch.distributed.tensor import DTensor
        mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
        if _ACTIVE is None or mesh is None:
            return fn(*args)

        dropped = set()
        for spec, a in zip(in_specs, args):
            if spec is None or not isinstance(a, DTensor):
                continue
            bound = Spec(*(_ACTIVE.resolve(e) for e in spec))
            kept = fitted(bound, a.shape, mesh)
            dropped |= {e for e, k in zip(spec, kept) if e is not None and k is None}

        def bind(spec):
            if spec is None:
                return None
            return placements(Spec(*(None if e in dropped else _ACTIVE.resolve(e)
                                     for e in spec)), mesh)

        summed = set(_axes(_ACTIVE.resolve(partial))) if partial not in (None, *dropped) else set()

        def bind_out(spec):
            from torch.distributed.tensor import Partial
            return tuple(Partial() if name in summed and mesh.size(m) > 1 else p
                         for m, (name, p) in enumerate(zip(mesh.mesh_dim_names, bind(spec))))

        # local_map reads a tuple as one placement list per output
        outs = (list(bind_out(out_specs)) if isinstance(out_specs, Spec)
                else tuple(bind_out(s) for s in out_specs))
        return on_shards(fn, args, [bind(s) for s in in_specs], outs, mesh)

    return run
