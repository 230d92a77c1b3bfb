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
(:func:`repro_torch.kernels.bell_tables.runtime_table`), a tile's jets in
shared memory, and spread the dense epilogue over (element, output order)
as the table's slots say; :func:`act_jet_geometry` and
:func:`jet_dense_geometry` size their blocks, and the only order they
refuse is one whose smallest block does not fit (:func:`check_fits`).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import torch

from . import cuda_lib
from .bell_tables import HEADER_ORDER, RT_SLOTS, runtime_table
from .cuda_lib import LaunchCounter

KERNEL_ACTS = ("tanh", "sigmoid", "sin")
TEMPLATE_N1 = HEADER_ORDER + 1   # the templated kernels' largest N1 (csrc/act_jet.cuh)
ACT_CODES = {None: 0, "tanh": 1, "sigmoid": 2, "sin": 3}
# bfloat16 is loaded into float32, computed in float32 and stored as
# bfloat16, as the reference promotes it (promote_types(dtype, float32))
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
SMEM_LIMIT = 232448              # shared memory a block can use on Hopper
# csrc/jet_runtime.cu's dense run-time kernels (K1, K2): kDenseMaxWarps,
# kLane, kDenseCols, kRowTile, kMaxKc; a tile's elements in units of 32,
# its epilogue a warp a (group of 32 lanes x lane_elems elements; slot of
# bell_tables.order_slots)
_DENSE_WARPS = 8                 # warps of a block, at most
_DENSE_COLS = 32                 # K1: output columns of a tile, at most
_ROW_TILE = 8                    # K1: (plane, row) pairs a GEMM thread keeps
_MAX_KC = 32                     # K1: input columns staged at a time, at most
_SMS = 132                       # blocks shrink until the grid covers the SMs twice

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


class DenseGeometry(NamedTuple):
    """A K1/K2 run-time block: ``tile`` units of 32 elements (K2) or batch
    rows (K1, by ``cols`` output columns), ``kc`` input columns staged at a
    time (K1), ``warps``, whether the table is ``staged`` in shared memory
    (else read from device memory), and the block's shared bytes."""
    tile: int
    cols: int
    kc: int
    warps: int
    staged: bool
    smem: int


def lane_elems(dtype: torch.dtype) -> int:
    """Elements a lane of the dense epilogue takes: 32 bytes of the
    compute type (4 float64, 8 float32)."""
    return 32 // compute_itemsize(dtype)


def dense_smem(n1: int, elems: int, stage_words: int, item: int, table_bytes: int) -> int:
    """Shared bytes of a K1/K2 run-time block (csrc/jet_runtime.cu's
    dense_words and tile_bytes): the tile's stacks z and F, n1 words an element for
    ``elems`` elements rounded up to whole groups of 32; K1's GEMM staging
    (``stage_words``) shares F's room, which it leaves before F is
    written; 16-byte aligned, then the table when it is staged."""
    epad = 32 * math.ceil(elems / 32)
    words = n1 * epad + max(n1 * epad, stage_words)
    return -(-words * item // 16) * 16 + table_bytes


def _k1_smem(n1: int, item: int, rows: int, cols: int, kc: int, table: int) -> int:
    """Shared bytes of a K1 run-time block of ``rows`` x ``cols`` outputs
    staging ``kc`` input columns: x's n1 * rows rows padded to _ROW_TILE,
    then kc rows of w, in F's room."""
    stage = (_ROW_TILE * math.ceil(n1 * rows / _ROW_TILE) + cols) * kc
    return dense_smem(n1, rows * cols, stage, item, table)


def act_jet_min_smem(n1: int, dtype: torch.dtype) -> int:
    """Shared bytes of K2's smallest run-time block: 32 elements, the
    table left in device memory.  Past SMEM_LIMIT an order is refused."""
    return dense_smem(n1, 32, 0, compute_itemsize(dtype), 0)


def jet_dense_min_smem(n1: int, dtype: torch.dtype, dout: int) -> int:
    """Shared bytes of K1's smallest run-time block: one row, one input
    column staged at a time, the table left in device memory."""
    return _k1_smem(n1, compute_itemsize(dtype), 1, min(dout, _DENSE_COLS), 1, 0)


def _table_bytes(n: int) -> tuple[int, int]:
    """(slots, bytes) of :func:`runtime_table` of order ``n``."""
    ints, reals = runtime_table(n)
    return max(1, ints[RT_SLOTS]), 4 * len(ints) + 8 * len(reals)


def _shrink(tile: int, tiles) -> int:
    """Halve ``tile`` until the grid ``tiles(tile)`` covers the SMs twice."""
    while tile > 1 and tiles(tile) < 2 * _SMS:
        tile //= 2
    return tile


def act_jet_geometry(n1: int, dtype: torch.dtype, n_elem: int) -> DenseGeometry:
    """K2's run-time block: up to _DENSE_WARPS warps, one a (group of 32
    lanes x lane_elems elements, slot), shrunk until the grid covers the
    SMs twice; the table staged when it fits beside the tile, the tile
    halved before it is given up.  A block of 32 elements that does not
    fit is refused here, naming the bytes, before any table is built
    (:func:`act_jet_min_smem`)."""
    item = compute_itemsize(dtype)
    check_fits("act_jet", act_jet_min_smem(n1, dtype), f"order {n1 - 1} (32 elements)")
    slots, table = _table_bytes(n1 - 1)
    lanes = lane_elems(dtype)
    units = _shrink(lanes * max(1, _DENSE_WARPS // slots),
                    lambda u: math.ceil(n_elem / (32 * u)))
    for staged in (True, False):
        u = units
        while u > 1 and dense_smem(n1, 32 * u, 0, item, staged * table) > SMEM_LIMIT:
            u //= 2
        smem = dense_smem(n1, 32 * u, 0, item, staged * table)
        if smem <= SMEM_LIMIT:
            return DenseGeometry(u, 0, 0, min(_DENSE_WARPS, math.ceil(u / lanes) * slots),
                                 staged, smem)
    raise AssertionError("a block of 32 elements was checked to fit")


def jet_dense_geometry(n1: int, dtype: torch.dtype, bsz: int, din: int, dout: int,
                       activation: str | None) -> DenseGeometry:
    """K1's run-time block: a tile of ``tile`` rows x ``cols`` <= 32
    output columns (rows a multiple of 32 / gcd(cols, 32) where that keeps
    the units of 32 elements whole), its groups x slots warps as in K2, at
    most _DENSE_WARPS; the tile shrinks until the grid covers the SMs
    twice.  The GEMM stages ``kc`` input columns of x (n1 * rows rows,
    padded to _ROW_TILE) and w at a time; where the block does not fit, kc
    halves, then the rows, then the table is left in device memory.  A
    one-row block with kc = 1 that does not fit is refused, naming the
    bytes, before any table is built (:func:`jet_dense_min_smem`)."""
    item = compute_itemsize(dtype)
    cols = min(dout, _DENSE_COLS)

    def smem(rows: int, kc: int, table: int) -> int:
        return _k1_smem(n1, item, rows, cols, kc, table)

    check_fits("jet_dense", jet_dense_min_smem(n1, dtype, dout),
               f"order {n1 - 1} (one row of {cols} columns)")
    slots, table = (1, 0) if activation is None else _table_bytes(n1 - 1)
    whole = 32 // math.gcd(cols, 32)
    group = 32 * lane_elems(dtype)
    rows = max(1, group * max(1, _DENSE_WARPS // slots) // cols)
    rows = rows // whole * whole or rows
    rows = _shrink(rows, lambda r: math.ceil(bsz / r) * math.ceil(dout / cols))
    for staged in (True, False) if table else (False,):
        r = rows
        while True:
            kc = min(_MAX_KC, din)
            while kc > 1 and smem(r, kc, staged * table) > SMEM_LIMIT:
                kc //= 2
            if smem(r, kc, staged * table) <= SMEM_LIMIT:
                warps = min(_DENSE_WARPS, math.ceil(r * cols / group) * slots)
                return DenseGeometry(r, cols, kc, warps, staged,
                                     smem(r, kc, staged * table))
            if r == 1:
                break
            r //= 2
    raise AssertionError("a one-row block was checked to fit")


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
        geo = act_jet_geometry(n1, coeffs.dtype, b * w)
        ints, reals = device_tables(n1 - 1, str(coeffs.device))
        cuda_lib.launch("act_jet_rt_launch", coeffs.device, coeffs.data_ptr(),
                        out.data_ptr(), b * w, n1, ACT_CODES[activation],
                        DTYPE_CODES[coeffs.dtype], ints.data_ptr(), reals.data_ptr(),
                        ints.numel(), reals.numel(), geo.tile, geo.warps, int(geo.staged))
    else:
        cuda_lib.launch("act_jet_launch", coeffs.device, coeffs.data_ptr(),
                        out.data_ptr(), b * w, n1, ACT_CODES[activation],
                        DTYPE_CODES[coeffs.dtype])
    LAUNCHES.add()
    return out
