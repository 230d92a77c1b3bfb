"""Launch wrapper of K2, the standalone activation-jet kernel
(csrc/act_jet.cu; the reference's kernels/tanh_jet.py::act_jet_pallas).

Input is the scaled-Taylor coefficient stack of the pre-activations,
``(n+1, B, W)``.  One launch computes the full activation jet:

  1. ``u = tanh(c_0)``                       (sin: the sin/cos cycle)
  2. ``F_m = P_m(u)``                        (Horner chains, m = 0..n)
  3. ``out_k = sum_{p in P(k)} C_p F_|p| prod_j c_j^{p_j}``

Its plain version is :func:`repro_torch.kernels.ref.act_jet_ref`.  The
kernels read the partition terms and Horner rows as generated code
(csrc/fdb_tables.cuh, from :mod:`.bell_tables`); this module holds the
order limit of their templates and the checks both wrappers share.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .cuda_lib import LaunchCounter

KERNEL_ACTS = ("tanh", "sigmoid", "sin")
MAX_ORDER = 8                 # template N1 runs over 1..9 (csrc/act_jet.cuh)
_MAX_N1 = MAX_ORDER + 1
ACT_CODES = {None: 0, "tanh": 1, "sigmoid": 2, "sin": 3}
DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

LAUNCHES = LaunchCounter("act_jet")


def check_order(n_coeffs: int) -> None:
    """The kernels take stacks of 1..9 coefficients (orders 0..8)."""
    if not 1 <= n_coeffs <= _MAX_N1:
        raise ValueError(
            f"the CUDA jet kernels take orders 0..{MAX_ORDER} (a stack of at "
            f"most {_MAX_N1} coefficients), got order {n_coeffs - 1}")


def check_cuda_tensor(t: torch.Tensor, name: str, ndim: int,
                      dtype: torch.dtype | None = None) -> None:
    """Raise on anything the kernels do not take."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: the kernels take float32 or float64, "
                         f"got {t.dtype}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, want {dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def act_jet_cuda(coeffs: torch.Tensor, activation: str = "tanh") -> torch.Tensor:
    """K2 on the card: (n+1, B, W) -> the activation jet, same shape."""
    check_cuda_tensor(coeffs, "coeffs", 3)
    if activation not in KERNEL_ACTS:
        raise ValueError(f"act_jet kernel has no table for {activation!r}; "
                         f"it takes {KERNEL_ACTS}")
    n1, b, w = coeffs.shape
    check_order(n1)
    out = torch.empty_like(coeffs)
    cuda_lib.launch("act_jet_launch", coeffs.device, coeffs.data_ptr(),
                    out.data_ptr(), b * w, n1, ACT_CODES[activation],
                    DTYPE_CODES[coeffs.dtype])
    LAUNCHES.add()
    return out
