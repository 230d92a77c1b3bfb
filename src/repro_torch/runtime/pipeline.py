"""Pipeline parallelism: a GPipe microbatch schedule on a "stage" mesh axis.

For meshes deeper than the production 2 x 16 x 16 (or models whose layers
exceed what FSDP + TP can hold), layer groups become pipeline stages.  This
module provides the deterministic schedule as a composable primitive, the
JAX package's ``runtime/pipeline.py`` on a torch ``DeviceMesh``:

  * the model's layer groups are stacked on a leading ``stage`` axis and
    each rank of the mesh's ``stage`` dim applies its own slice;
  * microbatches stream through ``n_stages + n_micro - 1`` ticks; each
    tick every stage applies its block and hands its activation to the
    next stage (the last to the first, which ignores it, as the
    reference's ``ppermute`` ring does) over the stage dim's process group
    -- the classic GPipe bubble of (P-1)/(P-1+M) idle fraction;
  * outputs collect at the last stage and are returned replicated to every
    rank (a sum over the stage group of the last stage's outputs and the
    other stages' zeros).

Training runs autograd through the schedule: the hand-off is a
``torch.autograd.Function`` whose backward sends the gradient leftward, so
the backward is the reverse schedule (the bubble doubles, as in GPipe),
which is what ``jax.grad`` through ``ppermute`` yields in the reference.
The replicated outputs' gradient is taken to be the same on every rank (as
when every rank computes the same loss from them) and reaches the last
stage unchanged.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def _exchange(t: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``t`` to group rank ``to`` and receive a tensor like it from
    group rank ``frm``."""
    recv = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _HandRight(torch.autograd.Function):
    """Each stage's activation to the next stage (a ring); the backward
    hands each gradient to the previous stage."""

    @staticmethod
    def forward(ctx, t, group, sid: int, n: int):
        ctx.group, ctx.sid, ctx.n = group, sid, n
        return _exchange(t, group, (sid + 1) % n, (sid - 1) % n)

    @staticmethod
    def backward(ctx, grad):
        sid, n = ctx.sid, ctx.n
        return _exchange(grad, ctx.group, (sid - 1) % n, (sid + 1) % n), None, None, None


class _SumStages(torch.autograd.Function):
    """The sum over the stage group (replicating the last stage's
    outputs); the gradient of the replicated result passes through."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _stage_slice(leaf: torch.Tensor, sid: int) -> torch.Tensor:
    """This stage's slice of a leaf stacked over stages: row ``sid`` of a
    plain tensor, or the local shard of a DTensor sharded over the stage
    dim."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        return leaf.to_local()[0]
    return leaf[sid]


def gpipe(stage_fn: Callable, mesh, *, axis: str = "stage"):
    """Build a pipelined apply: (stage_params, microbatches) -> outputs.

    ``stage_fn(params_one_stage, x_mb) -> y_mb`` must be shape-preserving
    (residual-block style), as every stage runs the same program.
    ``stage_params`` leaves are stacked on a leading axis of size n_stages
    (whole on every rank, or DTensors sharded over ``axis``);
    ``microbatches`` is (n_micro, mb, ...), the same on every rank.  SPMD:
    every rank of the mesh calls it."""
    n_stages = mesh[axis].size()
    group = mesh.get_group(axis)
    sid = mesh.get_local_rank(axis)

    def pipelined(stage_params, xs):
        n_micro = xs.shape[0]
        ticks = n_micro + n_stages - 1
        params = tree_map(lambda leaf: _stage_slice(leaf, sid), stage_params)
        first = torch.tensor(sid == 0, device=xs.device)
        buf = torch.zeros_like(xs[0])
        outs = []
        for t in range(ticks):
            # stage 0 ingests microbatch t (clipped); the others take the
            # activation the previous stage handed over
            inp = torch.where(first, xs[min(t, n_micro - 1)], buf)
            out = stage_fn(params, inp)
            outs.append(out)
            buf = _HandRight.apply(out, group, sid, n_stages) if n_stages > 1 else out
        # microbatch m exits the last stage at tick m + n_stages - 1
        done = torch.stack(outs[n_stages - 1:n_stages - 1 + n_micro])
        if sid != n_stages - 1:
            done = done * 0
        return _SumStages.apply(done, group) if n_stages > 1 else done

    return pipelined


def pipeline_bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe idle fraction: (P-1)/(P-1+M); the scheduling-efficiency term."""
    return (n_stages - 1) / (n_stages - 1 + n_micro)
