"""Launch wrapper of K2, the standalone activation-jet kernel
(csrc/act_jet.cu; the reference's kernels/tanh_jet.py::act_jet_pallas).

Input is the scaled-Taylor coefficient stack of the pre-activations,
``(n+1, B, W)``.  One launch computes the full activation jet:

  1. ``u = tanh(c_0)``                       (sin: the sin/cos cycle)
  2. ``F_m = P_m(u)``                        (Horner chains, m = 0..n)
  3. ``out_k = sum_{p in P(k)} C_p F_|p| prod_j c_j^{p_j}``

Its plain version is :func:`repro_torch.kernels.ref.act_jet_ref`.  This
module also holds what every wrapper shares: the dtype codes, the checks,
and the choice between the two kernel families.  The templated kernels
(one instantiation per coefficient count N1 <= :data:`TEMPLATE_N1`, float32
and float64) read the partition terms and Horner rows as generated code
(csrc/fdb_tables.cuh).  The run-time-order kernels (csrc/jet_runtime.cu)
take any N1 and bfloat16: they read the same tables as data
(:func:`repro_torch.kernels.bell_tables.runtime_table`) and keep each
thread's coefficients in shared memory, so the only order they refuse is
one whose working set does not fit a block (:func:`check_fits`).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import cuda_lib
from .bell_tables import HEADER_ORDER, runtime_table
from .cuda_lib import LaunchCounter

KERNEL_ACTS = ("tanh", "sigmoid", "sin")
TEMPLATE_N1 = HEADER_ORDER + 1   # the templated kernels' largest N1 (csrc/act_jet.cuh)
ACT_CODES = {None: 0, "tanh": 1, "sigmoid": 2, "sin": 3}
# bfloat16 is loaded into float32, computed in float32 and stored as
# bfloat16, as the reference promotes it (promote_types(dtype, float32))
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
SMEM_LIMIT = 232448              # shared memory a block can use on Hopper
_RT_THREADS = 128                # csrc/jet_runtime.cu: largest elementwise block

LAUNCHES = LaunchCounter("act_jet")


def runtime_path(n1: int, dtype: torch.dtype) -> bool:
    """Does a launch of ``n1`` coefficients of ``dtype`` take the
    run-time-order kernel (csrc/jet_runtime.cu) rather than a template?"""
    return n1 > TEMPLATE_N1 or dtype == torch.bfloat16


def compute_itemsize(dtype: torch.dtype) -> int:
    """Bytes of the type a kernel computes in: float64, else float32."""
    return 8 if dtype == torch.float64 else 4


def check_depth(n1: int) -> None:
    """A stack holds at least one coefficient (order 0); no order is capped."""
    if n1 < 1:
        raise ValueError(f"a jet stack holds n+1 >= 1 coefficients, got {n1}")


def check_fits(kernel: str, smem: int, what: str) -> None:
    """Raise, naming the bytes, when a block's working set exceeds the
    shared memory a block can use."""
    if smem > SMEM_LIMIT:
        raise ValueError(f"the {kernel} kernel needs {smem} bytes of shared memory "
                         f"for {what}; a block has {SMEM_LIMIT}")


def runtime_threads(n1: int, dtype: torch.dtype) -> tuple[int, int]:
    """(threads, shared bytes) of a K1/K2 run-time-order block: each thread
    keeps its element's 2 n1 coefficients (the stack and the Taylor stack
    F) in shared memory; blocks shrink from 128 threads to one warp."""
    item = compute_itemsize(dtype)
    threads = _RT_THREADS
    while threads > 32 and 2 * n1 * threads * item > SMEM_LIMIT:
        threads //= 2
    return threads, 2 * n1 * threads * item


@lru_cache(maxsize=None)
def device_tables(n: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`runtime_table` of order ``n`` on ``device``, made once: the
    int32 records and float64 coefficients the run-time kernels read."""
    ints, reals = runtime_table(n)
    return (torch.tensor(ints, dtype=torch.int32, device=device),
            torch.tensor(reals, dtype=torch.float64, device=device))


def check_cuda_tensor(t: torch.Tensor, name: str, ndim: int,
                      dtype: torch.dtype | None = None) -> None:
    """Raise on anything the kernels do not take."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: the kernels take float32, float64 or bfloat16, "
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
    check_depth(n1)
    out = torch.empty_like(coeffs)
    if runtime_path(n1, coeffs.dtype):
        threads, smem = runtime_threads(n1, coeffs.dtype)
        check_fits("act_jet", smem, f"order {n1 - 1} ({threads} threads)")
        ints, reals = device_tables(n1 - 1, str(coeffs.device))
        cuda_lib.launch("act_jet_rt_launch", coeffs.device, coeffs.data_ptr(),
                        out.data_ptr(), b * w, n1, ACT_CODES[activation],
                        DTYPE_CODES[coeffs.dtype], ints.data_ptr(), reals.data_ptr(),
                        threads)
    else:
        cuda_lib.launch("act_jet_launch", coeffs.device, coeffs.data_ptr(),
                        out.data_ptr(), b * w, n1, ACT_CODES[activation],
                        DTYPE_CODES[coeffs.dtype])
    LAUNCHES.add()
    return out
