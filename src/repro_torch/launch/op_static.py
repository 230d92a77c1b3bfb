"""Static analysis of one eager step, op by op: the FLOPs, the memory
traffic and the collective bytes that one rank dispatches, and the peak of
its live temporaries.

The port's counterpart of the JAX package's ``launch/hlo_static.py``.
There the optimized HLO is parsed and every ``while`` body multiplied by
its trip count; the port has no HLO, so the step's own dispatch is the IR:
:class:`OpCounter`, a ``TorchDispatchMode``, sees every aten op the step
runs, and the eager loops (the layer stack, the GLA and RWKV chunks, the
attention chunks, the recomputation in the backward) are counted as they
run, which is the trip-count multiplication's counterpart.

* Only local ops count.  An op with a ``DTensor`` among its arguments is
  handed back to DTensor (the mode returns ``NotImplemented``), whose local
  ops on the rank's shards then reach the mode; ``FlopCounterMode`` counts
  such work twice, once at the global shape.  DTensor's sharding
  propagation runs each new op signature once on global-shape fake
  tensors; those ops are not the rank's and are skipped
  (``_in_propagation``).
* FLOPs: dot FLOPs by ``torch.utils.flop_counter``'s formulas for mm,
  addmm, bmm, baddbmm and convolution (2 x |result| x the contracted size,
  the reference's ``dot_flops``).
* Bytes: the reference's buffer model, 2 x the result bytes of every op
  that materializes a buffer; views, ``empty`` and ops without a tensor
  result are excluded.  An in-place index or scatter update counts 2 x its
  update's bytes, as the reference's ``dynamic-update-slice`` and
  ``scatter`` do.
* Collectives: result bytes and counts for each kind (the reference's
  five; point-to-point send/recv is its ``collective-permute``), and the
  bytes for each mesh dim, from the group name the op carries
  (:func:`group_dims`).  A collective's result also counts as traffic.
* Memory: each storage an op creates is live from its creation until it
  is freed (a finalizer on the storage); :attr:`OpCounter.peak_bytes` is
  the most that was live at once.

The counter keeps an op log (one row for each distinct op record, with its
count), from which :func:`totals_from_log` recomputes the totals without
running the step again (``dryrun --reanalyze``).
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# op name (namespace.name, no overload) -> collective kind
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "collective-permute",
    "c10d.scatter_": "collective-permute",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}

# dot ops whose FLOPs count (torch.utils.flop_counter's formulas)
_DOTS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm", "aten.convolution",
         "aten._convolution", "aten.convolution_backward")

# in-place updates that write only their update operand: op -> its index
_UPDATES = {"aten.index_put_": 2, "aten._index_put_impl_": 2, "aten.index_copy_": 3,
            "aten.index_add_": 3, "aten.scatter_": 3, "aten.scatter_add_": 3,
            "aten.scatter_reduce_": 3, "aten.copy_": 1, "aten.slice_scatter": 1,
            "aten.select_scatter": 1}

# ops that allocate without writing, or do no work on the device
_NO_TRAFFIC = ("aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
               "aten.new_empty_strided", "aten.lift_fresh", "aten.lift_fresh_copy",
               "aten._local_scalar_dense", "_c10d_functional.wait_tensor")


def _name(func) -> str:
    """``namespace.name`` of an op overload (``aten.mm``)."""
    return f"{func.namespace}.{func._schema.name.split('::')[-1]}"


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


@dataclass
class Totals:
    """The reference's totals, and the collective bytes for each mesh dim
    (``collective_dims``), the op count and the peak of live temporaries."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    collective_dims: Dict[str, float] = field(default_factory=dict)
    ops: int = 0
    peak_bytes: int = 0

    def add_collective(self, kind: str, nbytes: float, mult: float, dim: str = "?"):
        self.collective_bytes[kind] = self.collective_bytes.get(kind, 0.0) + nbytes * mult
        self.collective_counts[kind] = self.collective_counts.get(kind, 0.0) + mult
        self.collective_dims[dim] = self.collective_dims.get(dim, 0.0) + nbytes * mult

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def group_dims(mesh) -> Dict[str, str]:
    """{process-group name: mesh dim name} of every dim of ``mesh`` (a
    ``DeviceMesh``).  A collective over another group (DTensor flattens
    mesh dims for a reduction over several) is filed under the dims its
    ranks span, "data+model" (:func:`_dims_of`)."""
    if mesh is None:
        return {}
    return {mesh.get_group(name).group_name: name for name in mesh.mesh_dim_names}


def _dims_of(group: str, mesh) -> str:
    """The mesh dims along which the ranks of process group ``group``
    differ, joined by "+" ("?" where the group is not on the mesh)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    try:
        ranks = dist.get_process_group_ranks(_resolve_process_group(group))
    except (ValueError, RuntimeError, KeyError):
        return "?"
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        grid = mesh.mesh.tolist()
    where = {}

    def walk(node, at):
        for i, sub in enumerate(node):
            if isinstance(sub, list):
                walk(sub, at + (i,))
            else:
                where[sub] = at + (i,)

    walk(grid, ())
    if not all(r in where for r in ranks):
        return "?"
    coords = [where[r] for r in ranks]
    return "+".join(n for d, n in enumerate(mesh.mesh_dim_names)
                    if len({c[d] for c in coords}) > 1) or "?"


def _group_name(args) -> Optional[str]:
    for a in args:
        if isinstance(a, str):
            return a
        name = getattr(a, "group_name", None)
        if isinstance(name, str):
            return name
    return None


class _Dims(dict):
    """``group_dims(mesh)``, resolving any other group it is asked for."""

    def __init__(self, mesh):
        super().__init__(group_dims(mesh))
        self.mesh = mesh

    def get(self, group, default="?"):
        if group is None or self.mesh is None:
            return default
        if group not in self:
            with not_counted():
                self[group] = _dims_of(group, self.mesh)
        return self[group]


def _record(name: str, func, args, kwargs, out, dims: Dict[str, str]) -> Optional[tuple]:
    """(op, flops, result bytes, update bytes, collective kind, mesh dim) of
    one call, or None for an op the analysis does not see (a view, an
    allocation without a write, no tensor result)."""
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    kind = _COLLECTIVES.get(name)
    if kind is None and (not outs or func.is_view or name in _NO_TRAFFIC):
        return None
    flops = 0
    if name in _DOTS:
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
    res = sum(_nbytes(t) for t in outs)
    upd = None
    if name in _UPDATES:
        i = _UPDATES[name]
        src = args[i] if len(args) > i else next(iter(kwargs.values()), None)
        upd = sum(_nbytes(t) for t in tree_leaves(src))
    dim = dims.get(_group_name(tree_leaves((args, kwargs))), "?") if kind else None
    return (name, flops, res, upd, kind, dim)


def _fold(totals: Totals, rec: tuple, mult: float) -> None:
    """Add ``mult`` calls of the record ``rec`` to ``totals``."""
    name, flops, res, upd, kind, dim = rec
    totals.ops += mult
    totals.flops += flops * mult
    totals.bytes += 2 * (res if upd is None else upd) * mult
    if kind is not None:
        totals.add_collective(kind, res, mult, dim)


def totals_from_log(log) -> Totals:
    """The totals of an op log (:meth:`OpCounter.log`: rows of
    ``[op, flops, result bytes, update bytes, kind, dim, count]``)."""
    totals = Totals()
    for row in log:
        _fold(totals, tuple(row[:6]), row[6])
    return totals


_PROPAGATING = [0]


def _in_propagation() -> bool:
    return _PROPAGATING[0] > 0


@contextlib.contextmanager
def not_counted():
    """Ops dispatched inside are DTensor's own bookkeeping (shard sizes and
    offsets), not the rank's work: the counter skips them."""
    _PROPAGATING[0] += 1
    try:
        yield
    finally:
        _PROPAGATING[0] -= 1


def _wrap_propagation():
    """Mark DTensor's tensor-meta propagation (global-shape ops on its own
    fake tensors) while it runs; returns the undo.  It fails loudly where
    the method is missing: the counts would take the global ops."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def wrapped(self, *args, **kwargs):
        with not_counted():
            return orig(self, *args, **kwargs)

    ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
    return lambda: setattr(ShardingPropagator, "_propagate_tensor_meta_non_cached", orig)


class OpCounter(TorchDispatchMode):
    """Counts the local ops dispatched while it is active (see the module
    notes); ``mesh`` names the mesh dims of the collectives.  After the
    ``with`` block: :attr:`totals` and :meth:`log`."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.dims = _Dims(mesh)
        self.records: Dict[tuple, int] = {}
        self.live = 0
        self.peak_bytes = 0
        self._storages: Dict[int, int] = {}
        self._undo = None

    def __enter__(self):
        self._undo = _wrap_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._undo()

    def _freed(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or type(t).__name__ == "DTensor":
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            self._storages[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._freed, key)
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(isinstance(a, DTensor) for a in tree_leaves((args, kwargs))):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        rec = _record(_name(func), func, args, kwargs, out, self.dims)
        if rec is not None:
            self.records[rec] = self.records.get(rec, 0) + 1
        self._track(out)
        return out

    @property
    def totals(self) -> Totals:
        totals = totals_from_log(self.log())
        totals.peak_bytes = self.peak_bytes
        return totals

    def log(self) -> list:
        """The op log: ``[op, flops, result bytes, update bytes, kind, dim,
        count]`` for each distinct record, most bytes first."""
        rows = [list(rec) + [n] for rec, n in self.records.items()]
        return sorted(rows, key=lambda r: -(r[2] if r[3] is None else r[3]) * r[6])


def analyze(fn, *args, mesh=None, **kwargs):
    """``(fn(*args, **kwargs), totals)`` with ``fn`` run once under an
    :class:`OpCounter`."""
    with OpCounter(mesh) as counter:
        out = fn(*args, **kwargs)
    return out, counter.totals
