"""Launch wrapper of K1, the fused n-TangentProp dense layer
(csrc/jet_dense.cu; the reference's kernels/jet_dense.py::jet_dense_pallas).

One layer of the paper's Algorithm 1 is ``jet -> W @ jet + b -> act-jet``.
The kernel does both in one launch: a block stages a tile of rows (all
``n+1`` coefficient planes) and of ``w`` in shared memory, each thread
accumulates a register tile of one row x several columns over every plane,
adds the bias to ``c_0`` only, and runs the Faa di Bruno epilogue it
shares with K2 before a single store, so the pre-activation stack never
goes to device memory.  f32 accumulates in f32, f64 in f64.  The tiling
is the launcher's (csrc/jet_dense.cu); this wrapper checks and launches.
Orders above the templates and bfloat16 (accumulated in f32) take the
run-time-order kernel of csrc/jet_runtime.cu: a tile of rows x up to 32
columns, its GEMM part staged and accumulated like the templated one's,
then the epilogue spread over (element, output order), a warp a slot of
orders for 32 lanes of several elements, the tile's stacks in shared
memory (``tanh_jet.jet_dense_geometry`` sizes it).

Its plain version is :func:`repro_torch.kernels.ref.jet_dense_ref`.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .cuda_lib import LaunchCounter
from .tanh_jet import (ACT_CODES, DTYPE_CODES, KERNEL_ACTS, check_cuda_tensor,
                       check_depth, device_tables, jet_dense_geometry, runtime_path)

LAUNCHES = LaunchCounter("jet_dense")


def jet_dense_cuda(coeffs: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   activation: str | None = "tanh") -> torch.Tensor:
    """K1 on the card: (n+1, B, Din) x (Din, Dout) -> (n+1, B, Dout)."""
    check_cuda_tensor(coeffs, "coeffs", 3)
    check_cuda_tensor(w, "w", 2, coeffs.dtype)
    check_cuda_tensor(b, "b", 1, coeffs.dtype)
    if w.device != coeffs.device or b.device != coeffs.device:
        raise ValueError(f"coeffs, w and b must share a device, got "
                         f"{coeffs.device}, {w.device}, {b.device}")
    if activation is not None and activation not in KERNEL_ACTS:
        raise ValueError(f"jet_dense kernel has no epilogue for "
                         f"{activation!r}; it takes None or {KERNEL_ACTS}")
    n1, bsz, din = coeffs.shape
    check_depth(n1)
    if w.shape[0] != din or b.shape[0] != w.shape[1]:
        raise ValueError(f"shapes do not chain: coeffs {tuple(coeffs.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    dout = w.shape[1]
    out = torch.empty((n1, bsz, dout), dtype=coeffs.dtype, device=coeffs.device)
    if runtime_path(n1, coeffs.dtype):
        geo = jet_dense_geometry(n1, coeffs.dtype, bsz, din, dout, activation)
        ints, reals = device_tables(n1 - 1, str(coeffs.device))
        cuda_lib.launch("jet_dense_rt_launch", coeffs.device, coeffs.data_ptr(),
                        w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, din, dout,
                        n1, ACT_CODES[activation], DTYPE_CODES[coeffs.dtype],
                        ints.data_ptr(), reals.data_ptr(), ints.numel(), reals.numel(),
                        geo.tile, geo.kc, geo.warps, int(geo.staged))
    else:
        cuda_lib.launch("jet_dense_launch", coeffs.device, coeffs.data_ptr(),
                        w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, din, dout,
                        n1, ACT_CODES[activation], DTYPE_CODES[coeffs.dtype])
    LAUNCHES.add()
    return out
