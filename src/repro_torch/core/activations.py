"""Closed-form higher derivatives of smooth activation functions.

The Faa di Bruno contraction (core/jet.py) needs all outer coefficients
``F_m = sigma^(m)(a)/m!`` for ``m = 0..n`` at the primal activations ``a``.
Every supported activation provides them in closed form:

* ``tanh``:    sigma' = 1 - u^2 with u = tanh(a).  Every derivative is a
               polynomial in u via the recurrence P_{m+1}(u) = P_m'(u)(1-u^2).
* ``sigmoid``: same trick with s' = s(1-s); s itself is 0.5 (tanh(a/2) + 1),
               as in the reference, not ``torch.sigmoid``.
* ``softplus``:softplus' = sigmoid, so order-m derivatives reuse the sigmoid
               polynomials shifted by one.
* ``sin``:     sigma^(m)(a) = sin(a + m*pi/2).
* ``exp``:     sigma^(m) = exp.
* ``identity``/``silu``/``gelu``/``relu`` go through the jet algebra
               (core/jet.py) rather than a direct table.

Polynomial coefficient tables are exact integers computed once (lru_cache);
evaluation is Horner in the activation value.  The CUDA kernels take the
same tables from kernels/bell_tables.py.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, Dict, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Exact integer polynomial tables
# ---------------------------------------------------------------------------

def _poly_mul(a: Tuple[int, ...], b: Tuple[int, ...]) -> Tuple[int, ...]:
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] += ai * bj
    return tuple(out)


def _poly_diff(a: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(i * ai for i, ai in enumerate(a))[1:] or (0,)


@lru_cache(maxsize=None)
def tanh_derivative_polys(n: int) -> Tuple[Tuple[int, ...], ...]:
    """P_m with tanh^(m)(a) = P_m(tanh(a)), for m = 0..n.  P_0 = u."""
    polys = [(0, 1)]  # P_0(u) = u
    dchain = (1, 0, -1)  # u' = 1 - u^2
    for _ in range(n):
        polys.append(_poly_mul(_poly_diff(polys[-1]), dchain))
    return tuple(polys)


@lru_cache(maxsize=None)
def sigmoid_derivative_polys(n: int) -> Tuple[Tuple[int, ...], ...]:
    """Q_m with sigmoid^(m)(a) = Q_m(sigmoid(a)), for m = 0..n.  Q_0 = s."""
    polys = [(0, 1)]  # Q_0(s) = s
    dchain = (0, 1, -1)  # s' = s - s^2
    for _ in range(n):
        polys.append(_poly_mul(_poly_diff(polys[-1]), dchain))
    return tuple(polys)


def poly_table_f32(polys: Tuple[Tuple[int, ...], ...]) -> np.ndarray:
    """Pack ragged integer polys into a dense (m+1, deg+1) float array (low->high)."""
    deg = max(len(p) for p in polys)
    out = np.zeros((len(polys), deg), dtype=np.float64)
    for i, p in enumerate(polys):
        out[i, : len(p)] = p
    return out


def _horner(table_row: np.ndarray, u: torch.Tensor) -> torch.Tensor:
    """Evaluate sum_i c_i u^i with Horner; table_row is low->high order."""
    acc = torch.full_like(u, float(table_row[-1]))
    for c in table_row[-2::-1]:
        acc = acc * u + float(c)
    return acc


# ---------------------------------------------------------------------------
# Taylor-coefficient stacks F_m = sigma^(m)(a)/m!
# ---------------------------------------------------------------------------

def tanh_taylor_stack(a: torch.Tensor, n: int) -> torch.Tensor:
    """(n+1, *a.shape) stack of tanh^(m)(a)/m!."""
    u = torch.tanh(a)
    table = poly_table_f32(tanh_derivative_polys(n))
    rows = [u]
    for m in range(1, n + 1):
        rows.append(_horner(table[m], u) * (1.0 / math.factorial(m)))
    return torch.stack(rows)


def sigmoid_taylor_stack(a: torch.Tensor, n: int) -> torch.Tensor:
    s = torch_sigmoid(a)
    table = poly_table_f32(sigmoid_derivative_polys(n))
    rows = [s]
    for m in range(1, n + 1):
        rows.append(_horner(table[m], s) * (1.0 / math.factorial(m)))
    return torch.stack(rows)


def _softplus(a: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(a, torch.zeros_like(a))


def softplus_taylor_stack(a: torch.Tensor, n: int) -> torch.Tensor:
    """softplus^(0) = log1p(exp a); higher orders are sigmoid derivatives shifted by one."""
    rows = [_softplus(a)]
    if n >= 1:
        s = torch_sigmoid(a)
        table = poly_table_f32(sigmoid_derivative_polys(max(n - 1, 0)))
        for m in range(1, n + 1):
            rows.append(_horner(table[m - 1], s) * (1.0 / math.factorial(m)))
    return torch.stack(rows)


def sin_taylor_stack(a: torch.Tensor, n: int) -> torch.Tensor:
    rows = []
    for m in range(n + 1):
        phase = m % 4
        val = [torch.sin, torch.cos, lambda x: -torch.sin(x),
               lambda x: -torch.cos(x)][phase](a)
        rows.append(val * (1.0 / math.factorial(m)))
    return torch.stack(rows)


def exp_taylor_stack(a: torch.Tensor, n: int) -> torch.Tensor:
    e = torch.exp(a)
    return torch.stack([e * (1.0 / math.factorial(m)) for m in range(n + 1)])


def torch_sigmoid(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.tanh(0.5 * a) + 1.0)


# registry: name -> callable(a, n) -> (n+1, *shape) Taylor stack
TAYLOR_STACKS: Dict[str, Callable[[torch.Tensor, int], torch.Tensor]] = {
    "tanh": tanh_taylor_stack,
    "sigmoid": sigmoid_taylor_stack,
    "softplus": softplus_taylor_stack,
    "sin": sin_taylor_stack,
    "exp": exp_taylor_stack,
}

# tanh-approximation GELU constants, shared with the jet-side composition
# (repro_torch.core.jet.gelu) so primal and jet can never drift apart
GELU_TANH_C = math.sqrt(2.0 / math.pi)
GELU_TANH_CUBIC = 0.044715

# plain primal evaluation (for order-0 fast paths).  The composite names
# (silu / gelu / relu / identity) have no Taylor table -- their jets go
# through repro_torch.core.jet.activation's algebraic definitions instead.
PRIMALS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": torch.tanh,
    "sigmoid": torch_sigmoid,
    "softplus": _softplus,
    "sin": torch.sin,
    "exp": torch.exp,
    "silu": lambda a: a * torch_sigmoid(a),
    "gelu": lambda a: 0.5 * a * (1.0 + torch.tanh(
        GELU_TANH_C * (a + GELU_TANH_CUBIC * a ** 3))),
    "relu": lambda a: torch.clamp(a, min=0.0),
    "identity": lambda a: a,
}
