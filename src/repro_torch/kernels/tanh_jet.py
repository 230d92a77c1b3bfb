"""Launch wrapper of K2, the standalone activation-jet kernel
(csrc/act_jet.cu; the reference's kernels/tanh_jet.py::act_jet_pallas).

Input is the scaled-Taylor coefficient stack of the pre-activations,
``(n+1, B, W)``.  One launch computes the full activation jet:

  1. ``u = tanh(c_0)``                       (sin: the sin/cos cycle)
  2. ``F_m = P_m(u)``                        (Horner chains, m = 0..n)
  3. ``out_k = sum_{p in P(k)} C_p F_|p| prod_j c_j^{p_j}``

Its plain version is :func:`repro_torch.kernels.ref.act_jet_ref`.  This
module also packs the tables both kernels read (:func:`device_tables`) and
holds the order limit of the kernels' templates.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_lib
from .bell_tables import fdb_terms, sigmoid_poly_rows, tanh_poly_rows
from .cuda_lib import LaunchCounter

KERNEL_ACTS = ("tanh", "sigmoid", "sin")
MAX_ORDER = 8                 # template N1 runs over 1..9 (csrc/act_jet.cuh)
_MAX_N1 = MAX_ORDER + 1
_POLY_W = _MAX_N1 + 1
ACT_CODES = {None: 0, "tanh": 1, "sigmoid": 2, "sin": 3}
DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

LAUNCHES = LaunchCounter("act_jet")


def check_order(n_coeffs: int) -> None:
    """The kernels take stacks of 1..9 coefficients (orders 0..8)."""
    if not 1 <= n_coeffs <= _MAX_N1:
        raise ValueError(
            f"the CUDA jet kernels take orders 0..{MAX_ORDER} (a stack of at "
            f"most {_MAX_N1} coefficients), got order {n_coeffs - 1}")


@lru_cache(maxsize=None)
def _host_tables() -> tuple[np.ndarray, np.ndarray, int]:
    """(ints, vals, n_terms) in the layout of csrc/act_jet.cuh::Tables:
    ints = starts[9] ++ terms[n_terms][2] with terms = (|p|, exponents in
    4-bit fields, p_1 lowest); vals = coef[n_terms] ++ tanh rows ++ sigmoid
    rows, each rows block (9, 10) low -> high."""
    starts, terms, coefs = [0], [], []
    for order_terms in fdb_terms(MAX_ORDER):
        for coef, m, powers in order_terms:
            packed = 0
            for j, e in powers:
                packed |= e << (4 * (j - 1))
            terms.append((m, packed))
            coefs.append(coef)
        starts.append(len(terms))
    poly = np.zeros((2, _MAX_N1, _POLY_W))
    for block, rows in enumerate((tanh_poly_rows(MAX_ORDER),
                                  sigmoid_poly_rows(MAX_ORDER))):
        for m, row in enumerate(rows):
            poly[block, m, :len(row)] = row
    ints = np.concatenate([np.asarray(starts, np.int32),
                           np.asarray(terms, np.int32).reshape(-1)])
    vals = np.concatenate([np.asarray(coefs, np.float64), poly.reshape(-1)])
    return ints, vals, len(terms)


class DeviceTables(NamedTuple):
    ints: torch.Tensor
    vals: torch.Tensor
    pointers: tuple   # (starts, terms, coef, poly) addresses for the launchers


@lru_cache(maxsize=None)
def device_tables(dtype: torch.dtype, device: torch.device) -> DeviceTables:
    """The packed tables on ``device``, values in ``dtype``.  Cached, so the
    tensors outlive every launch that reads them."""
    ints, vals, n_terms = _host_tables()
    ti = torch.as_tensor(ints, device=device)
    tv = torch.as_tensor(vals, device=device).to(dtype)
    ptrs = (ti.data_ptr(), ti.data_ptr() + _MAX_N1 * ti.element_size(),
            tv.data_ptr(), tv.data_ptr() + n_terms * tv.element_size())
    return DeviceTables(ti, tv, ptrs)


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
    tables = device_tables(coeffs.dtype, coeffs.device)
    cuda_lib.launch("act_jet_launch", coeffs.device, coeffs.data_ptr(),
                    out.data_ptr(), b * w, n1, ACT_CODES[activation],
                    DTYPE_CODES[coeffs.dtype], *tables.pointers)
    LAUNCHES.add()
    return out
