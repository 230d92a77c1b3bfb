"""Data-parallel jet computation and training over ``torch.distributed``.

The paper's quasilinear jet forward is embarrassingly data-parallel over
collocation points: every row of a batched jet is computed independently
and the coefficient axis stays local to each point.  The reference runs one
controller over a JAX mesh (``shard_map``); the port is SPMD: every rank of
a process group runs the same program on its own contiguous shard of the
batch, on its own device, with the parameters replicated.

* :class:`DataMesh` is the port's mesh: a process group (the default group
  unless given) seen as one ``"data"`` axis of its world size;
* :func:`resolve_mesh` is the one config knob -> mesh policy shared by the
  trainer, the losses and the server;
* :class:`ShardedEngine` wraps any engine: each rank runs the inner
  engine's ``derivs`` on its shard (under ``ntp/cuda`` that launches K1
  and, on the Transformer trunk, K3 and K4 on the rank's own device), and
  the table is gathered, so ``grid`` and ``cross`` are assembled from the
  whole table in the order of a single-process call.  Under autograd the
  gather hands each rank the gradient of its own rows, once, and the
  replicated parameters' gradients are summed over the ranks, as the
  transpose of ``shard_map`` does: every rank then holds the gradient of
  the whole objective;
* :func:`build_sharded_train_step` is one data-parallel Adam step: local
  loss and gradient on the rank's shard scaled by 1/n, the gradients
  summed over the ranks (exactly, or through a compressor of
  :mod:`repro_torch.parallel.compression`), the loss and aux summed, and
  the same Adam update on every rank.

Launch: ``torchrun --nproc-per-node N`` (NCCL on GPUs, each rank on
``cuda:LOCAL_RANK``), or ``torch.distributed.init_process_group`` with an
address, world size and rank.  Nothing here opens a process group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.engines import DerivativeEngine
from repro_torch.core.network import Network
from repro_torch.tree import leaves, unflatten

from .compression import compressed_psum_tree, ef_init, sum_over_ranks, topk_psum_tree

DATA_AXIS = "data"


@dataclass(frozen=True)
class DataMesh:
    """A process group seen as a 1-D ``"data"`` mesh: ``size`` ranks, this
    process is ``rank``.  ``group=None`` is the default group; another
    group (``torch.distributed.new_group``) gives the mesh its own ranks or
    timeout."""

    group: Any = None

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size}


def resolve_mesh(mesh=None, data_parallel: int = 0) -> Optional[DataMesh]:
    """The one knob -> mesh policy: an explicit mesh wins (a
    :class:`DataMesh`); ``data_parallel=N`` needs
    an initialised default process group of world size N and is a mesh
    over it; 0/None means a single process (no mesh).  It never falls back
    to a single process."""
    if mesh is not None:
        if not isinstance(mesh, DataMesh):
            raise ValueError(f"mesh {mesh!r} has no {DATA_AXIS!r} axis: pass a "
                             "repro_torch.parallel.DataMesh")
        return mesh
    if not data_parallel:
        return None
    n = int(data_parallel)
    if n < 1:
        raise ValueError(f"data_parallel must be >= 1, got {n}")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"data_parallel={n} needs an initialised torch.distributed process "
            f"group of {n} ranks: launch with `torchrun --nproc-per-node {n} ...` "
            "(NCCL on GPUs), or call torch.distributed.init_process_group first")
    if dist.get_world_size() != n:
        raise ValueError(f"data_parallel={n} but the default process group has "
                         f"{dist.get_world_size()} ranks")
    return DataMesh()


def pad_rows(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad the leading (batch) axis of ``x`` up to a multiple of
    ``multiple``; returns (padded, original row count).  Already divisible:
    ``x`` itself comes back.  Pad rows are well-defined inputs (zeros), and
    the caller slices them off."""
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1, got {multiple}")
    n = x.shape[0]
    rem = n % multiple
    if rem == 0:
        return x, n
    return torch.cat([x, x.new_zeros((multiple - rem,) + tuple(x.shape[1:]))]), n


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def gather_rows(local: torch.Tensor, dim: int, mesh: DataMesh) -> torch.Tensor:
    """Every rank's ``local`` (one shape on every rank) concatenated along
    ``dim``, rank order, on every rank.  Data movement only: the values are
    the ranks' values, bit for bit.  gloo runs only broadcast and
    all_reduce on CUDA tensors, so there :func:`gather_rows_by_sum` does
    the gather; every other backend runs ``all_gather``."""
    moved = local.movedim(dim, 0).contiguous()
    if moved.is_cuda and dist.get_backend(mesh.group) == "gloo":
        full = gather_rows_by_sum(moved, mesh)
    else:
        parts = [torch.empty_like(moved) for _ in range(mesh.size)]
        dist.all_gather(parts, moved, group=mesh.group)
        full = torch.cat(parts)
    return full.movedim(0, dim)


# the integer type gloo sums for each element width (it has no int16)
_SUM_VIEWS = {1: torch.uint8, 2: torch.uint8, 4: torch.int32, 8: torch.int64}


def gather_rows_by_sum(moved: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The ranks' ``moved`` (contiguous, one shape on every rank) stacked
    along dim 0 by one all_reduce: each rank writes its rows into a zero
    buffer and the buffers' integer views are summed.  Each entry has one
    term that is not all zero bits, and an integer sum with zeros keeps
    every bit pattern (a float sum would not: -0.0 + 0.0 is +0.0)."""
    m = moved.shape[0]
    full = moved.new_zeros((mesh.size * m,) + tuple(moved.shape[1:]))
    full[mesh.rank * m:(mesh.rank + 1) * m] = moved
    dist.all_reduce(full.view(-1).view(_SUM_VIEWS[full.element_size()]),
                    group=mesh.group)
    return full


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` whose backward gives each rank the gradient of its own
    rows, once.  Every rank computes the same loss on the gathered table,
    so each holds the whole table's gradient; a gather whose backward
    summed it over the ranks would count it once per rank."""

    @staticmethod
    def forward(ctx, local, dim, mesh):
        ctx.dim, ctx.lo, ctx.m = dim, mesh.rank * local.shape[dim], local.shape[dim]
        return gather_rows(local, dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.lo, ctx.m), None, None


class _Replicated(torch.autograd.Function):
    """Identity on the replicated parameters; the backward sums their
    gradients over the ranks, so the gradient that leaves a sharded call is
    the whole batch's on every rank (the transpose of a replicated
    ``shard_map`` input)."""

    @staticmethod
    def forward(ctx, group, *params):
        ctx.group = group
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *sum_over_ranks(grads, ctx.group))


def _replicated(params, mesh: DataMesh):
    ls = leaves(params)
    if not (torch.is_grad_enabled() and any(p.requires_grad for p in ls)):
        return params
    return unflatten(params, list(_Replicated.apply(mesh.group, *ls)))


# ---------------------------------------------------------------------------
# the sharded engine
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardedEngine(DerivativeEngine):
    """Run any engine's batched jet calls data-parallel over a
    :class:`DataMesh`.

    Only ``derivs`` is sharded: the batch is zero-padded to a multiple of
    the world size, rank r runs the inner engine on rows
    ``[r m, (r+1) m)`` and the table is gathered (pad rows sliced off).
    ``grid`` and ``cross`` are the base class's, so the direction tiling
    happens before the split and the polarization sum runs on the whole
    table, in a single-process call's order.  For the ntp engines a table
    equals the single-process one wherever each row's arithmetic does not
    depend on the batch size.

    ``spec`` reports the INNER engine's spec: the mesh is an execution
    detail (the server keys its cache on the mesh shape separately).
    """

    inner: DerivativeEngine
    mesh: DataMesh

    def __post_init__(self):
        if not isinstance(self.mesh, DataMesh):
            raise ValueError(f"mesh has no {DATA_AXIS!r} axis: pass a DataMesh")

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def spec(self) -> str:
        return self.inner.spec

    def derivs(self, net: Network, params, x: torch.Tensor, order: int,
               tangent: torch.Tensor | None = None) -> torch.Tensor:
        if tangent is None:
            tangent = torch.ones_like(x)
        n_sh = self.mesh.size
        xp, n = pad_rows(x, n_sh)
        vp, _ = pad_rows(tangent, n_sh)
        m = xp.shape[0] // n_sh
        lo = self.mesh.rank * m
        local = self.inner.derivs(net, _replicated(params, self.mesh),
                                  xp[lo:lo + m], order, vp[lo:lo + m])
        return _GatherRows.apply(local, 1, self.mesh)[:, :n]


# ---------------------------------------------------------------------------
# whole-step data-parallel training
# ---------------------------------------------------------------------------

def _compressor(compression: Optional[str]) -> Optional[Callable]:
    """Spec string -> (grads, err, group) -> (reduced grads, new err).

    ``None`` selects the exact sum; ``"int8"`` the shared-scale int8
    quantizer; ``"topk:F"`` magnitude top-k keeping fraction F (e.g.
    ``"topk:0.1"``).  Both compressors carry error feedback."""
    if compression is None:
        return None
    spec = str(compression).strip().lower()
    if spec in ("", "none"):
        return None
    if spec == "int8":
        return compressed_psum_tree
    if spec.startswith("topk:"):
        frac = float(spec.split(":", 1)[1])
        return lambda g, e, group: topk_psum_tree(g, e, group, k_frac=frac)
    raise ValueError(f"unknown grad compression {compression!r}; want "
                     "None, 'int8', or 'topk:<frac>' (e.g. 'topk:0.1')")


@dataclass
class ShardedTrainStep:
    """One data-parallel train step and its error-feedback initializer.
    ``step(params, opt_state, pts, err)`` -> ``(params, opt_state, (loss,
    aux), err)``: ``pts`` is the whole batch, the same on every rank, its
    rows a multiple of ``n_shards``; each rank keeps its own contiguous
    shard.  ``err`` is this rank's error-feedback tree."""

    step: Callable
    init_err: Callable
    n_shards: int
    compression: Optional[str]


def build_sharded_train_step(loss_fn: Callable, mesh: DataMesh, *, adam_lr: float,
                             compression: Optional[str] = None) -> ShardedTrainStep:
    """One data-parallel training step over ``mesh``.

    ``loss_fn(params, pts) -> (loss, aux)`` is the ordinary single-process
    objective (interior residual mean over ``pts`` plus replicated terms
    such as boundary supervision).  Each rank evaluates it on its shard
    scaled by ``1/n``; the sum of those over the ranks is the whole batch's
    objective (equal shards), so the sum of the local gradients is its
    gradient and the Adam update (``repro_torch.optim``, float32 update
    math as the reference's) stays in lockstep on every rank.
    ``compression`` routes the gradient sum through
    :mod:`repro_torch.parallel.compression`; off (None) by default."""
    from repro_torch.optim import adam_update
    from repro_torch.pinn.trainer import value_and_grad

    comp = _compressor(compression)
    n_sh, group = mesh.size, mesh.group

    def step(params, opt_state, pts, err):
        if pts.shape[0] % n_sh:
            raise ValueError(f"batch of {pts.shape[0]} rows does not divide the "
                             f"{n_sh}-way data axis; pick n_domain divisible by it")
        m = pts.shape[0] // n_sh
        local = pts[mesh.rank * m:(mesh.rank + 1) * m]

        def scaled_loss(p, xs):
            loss, aux = loss_fn(p, xs)
            return loss / n_sh, aux

        (loss, aux), grads = value_and_grad(scaled_loss, params, local)
        if comp is None:
            grads = unflatten(grads, sum_over_ranks(leaves(grads), group))
        else:
            grads, err = comp(grads, err, group)
        keys = list(aux)
        total = sum_over_ranks([loss] + [aux[k] / n_sh for k in keys], group)
        loss, aux = total[0], dict(zip(keys, total[1:]))
        params, opt_state = adam_update(grads, opt_state, params, adam_lr)
        return params, opt_state, (loss, aux), err

    def init_err(params) -> Any:
        """Zero error-feedback buffers (bfloat16) like ``params``: this
        rank's residual (all zero, and kept so, when compression is off)."""
        return ef_init(params)

    return ShardedTrainStep(step=step, init_err=init_err, n_shards=n_sh,
                            compression=compression)
