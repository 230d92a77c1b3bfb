"""Static coefficient tables shared by the CUDA kernels and their plain versions.

Everything here is plain Python computed once: the Faa di Bruno partition
terms (Taylor normalization) and the tanh/sigmoid derivative polynomial
rows.  The kernel wrappers pack them into a small device buffer
(kernels/tanh_jet.py::device_tables) that every launch reads, so one build
of the kernels serves every order up to the template limit.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

from repro_torch.core.activations import (sigmoid_derivative_polys,
                                          tanh_derivative_polys)
from repro_torch.core.partitions import faa_di_bruno_table


@lru_cache(maxsize=None)
def tanh_poly_rows(n: int) -> Tuple[Tuple[float, ...], ...]:
    """Row m: coefficients (low->high, in u=tanh(a)) of tanh^(m) / m!."""
    polys = tanh_derivative_polys(n)
    rows = []
    for m, p in enumerate(polys):
        inv = 1.0 / math.factorial(m)
        rows.append(tuple(float(c) * inv for c in p))
    return tuple(rows)


@lru_cache(maxsize=None)
def sigmoid_poly_rows(n: int) -> Tuple[Tuple[float, ...], ...]:
    polys = sigmoid_derivative_polys(n)
    rows = []
    for m, p in enumerate(polys):
        inv = 1.0 / math.factorial(m)
        rows.append(tuple(float(c) * inv for c in p))
    return tuple(rows)


@lru_cache(maxsize=None)
def fdb_terms(n: int) -> Tuple[Tuple[Tuple[float, int, Tuple[Tuple[int, int], ...]], ...], ...]:
    """fdb_terms(n)[k-1] = tuple of (coef, m, powers) for output order k."""
    out = []
    for k in range(1, n + 1):
        out.append(tuple((float(t.coef), t.order, t.powers)
                         for t in faa_di_bruno_table(k)))
    return tuple(out)


def flop_estimate(n: int, batch: int, width: int) -> int:
    """Rough FLOP count of one order-n tanh-jet epilogue on a tile."""
    per_elem = 0
    for k, terms in enumerate(fdb_terms(n), start=1):
        for _, _, powers in terms:
            per_elem += 2 + sum(e for _, e in powers)
    horner = sum(2 * (m + 1) for m in range(n + 1))
    return (per_elem + horner) * batch * width
