"""Gradient compression for the data-parallel all-reduce: int8 quantization
and magnitude top-k, both with error feedback.

* per-tensor symmetric int8 quantization (scale = max|g| / 127);
* error feedback (Karimireddy et al., arXiv:1901.09847): the compression
  residual is carried into the next step, so the *accumulated* update is
  unbiased and convergence matches the exact all-reduce asymptotically;
* the reduce runs on the int8 payload (summed as int32) under one scale
  shared by every rank, so the payloads sum exactly.

The reference reduces over a mesh axis inside ``shard_map``; here each rank
of a ``torch.distributed`` process group calls the tree functions on its
own gradients and error buffers (``group=None`` is the default group).  A
tree's leaves are reduced together: one ``all_reduce(MAX)`` of the
per-tensor maxima and one ``all_reduce(SUM)`` of the concatenated payload
(:func:`sum_over_ranks`, the package's one packed sum), whatever the
number of leaves.  The pure functions compute what the
reference's compute, bit for bit (float32 math, round half to even,
bfloat16 error buffers).
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, tree_map, unflatten


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g32 = g.float()
    scale = torch.amax(torch.abs(g32)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(g: torch.Tensor, err: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback compression of one tensor: (int8 payload, scale, new
    error residual in ``err``'s dtype)."""
    corrected = g.float() + err.float()
    q, scale = quantize_int8(corrected)
    new_err = corrected - dequantize_int8(q, scale)
    return q, scale, new_err.to(err.dtype)


def ef_init(grads) -> Any:
    """Zero error-feedback buffers (bfloat16) shaped like the gradient tree."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.bfloat16,
                                          device=g.device), grads)


def topk_mask(g: torch.Tensor, k_frac: float) -> torch.Tensor:
    """Boolean keep-mask of the ``ceil(k_frac * size)`` largest-|g| entries
    (per tensor, at least one entry kept)."""
    if not 0.0 < k_frac <= 1.0:
        raise ValueError(f"k_frac must be in (0, 1], got {k_frac}")
    mag = torch.abs(g.float())
    flat = mag.reshape(-1)
    k = max(1, math.ceil(flat.shape[0] * k_frac))
    if k >= flat.shape[0]:
        return torch.ones(g.shape, dtype=torch.bool, device=g.device)
    thresh = torch.topk(flat, k).values[-1]
    return mag >= thresh


def sum_over_ranks(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Each tensor summed over the ranks of ``group``, in one all-reduce per
    dtype (the tensors flattened and concatenated)."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def topk_psum_tree(grads, err_tree, group=None, k_frac: float = 0.1):
    """Magnitude top-k + error-feedback sum of a gradient tree over the
    ranks of ``group``.

    Each rank keeps only the ``k_frac`` largest-magnitude entries of its
    error-corrected gradient (chosen locally, so ranks keep *different*
    coordinates); the dropped mass is carried into the next step's residual.
    The reduce is a dense sum of the sparse-content tensors: the point is
    the estimator.  Returns (reduced grads, new error tree)."""
    gs, es = leaves(grads), leaves(err_tree)
    kept, new_err = [], []
    for g, err in zip(gs, es):
        corrected = g.float() + err.float()
        k = torch.where(topk_mask(corrected, k_frac), corrected,
                        torch.zeros_like(corrected))
        kept.append(k)
        new_err.append((corrected - k).to(err.dtype))
    total = sum_over_ranks(kept, group)
    return (unflatten(grads, [t.to(g.dtype) for t, g in zip(total, gs)]),
            unflatten(err_tree, new_err))


def compressed_psum_tree(grads, err_tree, group=None):
    """int8 + error-feedback sum of a gradient tree over the ranks of
    ``group``.  Returns (reduced grads in each leaf's dtype, new error
    tree)."""
    gs, es = leaves(grads), leaves(err_tree)
    corrected = [g.float() + e.float() for g, e in zip(gs, es)]
    # one scale per tensor, shared by every rank (one MAX all-reduce for the
    # whole tree), so the int8 payloads sum exactly: sum_i s q_i = s sum q
    maxima = torch.stack([torch.amax(torch.abs(c)) for c in corrected])
    dist.all_reduce(maxima, op=dist.ReduceOp.MAX, group=group)
    scales = maxima / 127.0 + 1e-30
    qs, new_err = [], []
    for c, s, err in zip(corrected, scales.unbind(0), es):
        q = torch.clamp(torch.round(c / s), -127, 127).to(torch.int8)
        qs.append(q)
        new_err.append((c - q.float() * s).to(err.dtype))
    total = sum_over_ranks([q.to(torch.int32) for q in qs], group)
    out = [(t.float() * s).to(g.dtype) for t, g, s in zip(total, gs, scales.unbind(0))]
    return unflatten(grads, out), unflatten(err_tree, new_err)
