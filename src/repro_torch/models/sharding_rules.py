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
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


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


def shard(x, *logical):
    """Constrain ``x`` to logical axes ("batch"/"model"/"seq"/None per dim):
    ``x`` redistributed to the bound placements on its own mesh.  A no-op
    when no rules are active or ``x`` is not a DTensor."""
    if _ACTIVE is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    target = placements(Spec(*(_ACTIVE.resolve(a) for a in logical)), x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


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


def local(fn: Callable, out_specs, in_specs) -> Callable:
    """``fn`` run on each rank's shards where DTensor has no sharding
    strategy for its ops (``torch.distributed.tensor.experimental.
    local_map``): its DTensor arguments are redistributed to the logical
    ``in_specs`` (one per argument, None for a non-tensor) bound by the
    active rules, ``fn`` sees their local tensors, and its outputs are
    wrapped with the bound ``out_specs`` (one spec, or a tuple of specs for
    a tuple of outputs).  Without active rules, or without a DTensor
    argument, it is ``fn`` itself.  ``fn`` must be local: it may read no
    row of another rank's shard."""

    def run(*args):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import local_map
        mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
        if _ACTIVE is None or mesh is None:
            return fn(*args)

        def bind(spec):
            return None if spec is None else placements(
                Spec(*(_ACTIVE.resolve(a) for a in spec)), mesh)

        # local_map reads a tuple as one placement list per output
        outs = (list(bind(out_specs)) if isinstance(out_specs, Spec)
                else tuple(bind(s) for s in out_specs))
        return local_map(fn, out_placements=outs,
                         in_placements=tuple(bind(s) for s in in_specs),
                         device_mesh=mesh, redistribute_inputs=True)(*args)

    return run

