"""Static coefficient tables shared by the CUDA kernels and their plain versions.

Everything here is plain Python computed once: the Faa di Bruno partition
terms (Taylor normalization) and the tanh/sigmoid derivative polynomial
rows.  The plain versions (ref.py) read them directly.  The CUDA kernels
read them two ways: the templated kernels (orders 0..HEADER_ORDER) as
straight-line code, csrc/fdb_tables.cuh, which :func:`cuda_header`
generates (``python -m repro_torch.kernels.bell_tables`` rewrites the
committed file); the run-time-order kernels (csrc/jet_runtime.cu) as data,
the arrays :func:`runtime_table` packs, for any order.
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


# ---------------------------------------------------------------------------
# csrc/jet_runtime.cu: the same tables as data, any order
# ---------------------------------------------------------------------------

# Header of runtime_table's int array: the order, then where each section
# starts (csrc/jet_runtime.cu reads the same positions).
RT_ORDER, RT_RECORDS, RT_COEFS, RT_TANH, RT_SIGMOID, RT_INV_FACT = range(6)
RT_HEADER = 6


@lru_cache(maxsize=None)
def runtime_table(n: int) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    """The epilogue's tables for orders 1..n as two flat arrays ``(ints,
    reals)``, for the run-time-order kernels.

    ``ints[:RT_HEADER]`` is the order and the start of each section.
    ``ints[ints[RT_RECORDS] + k - 1]`` (k = 1..n+1) is where the records of
    output order k start in ``ints`` (k = n + 1: where the last ends); a
    record is one Faa di Bruno term ``(m, count, j_1, .., j_count)``, the
    factors z_j in the order ref.py multiplies them.  ``ints[ints[RT_COEFS]
    + k - 1]`` is the index in ``reals`` of order k's first term
    coefficient.  ``ints[ints[RT_TANH] + m]`` (m = 0..n+1) bound Horner row
    m of tanh in ``reals`` (low -> high), likewise ``RT_SIGMOID``;
    ``reals[ints[RT_INV_FACT] + m]`` is 1 / m!, the sin stack's factor."""
    terms = fdb_terms(n)
    ints = [n] + [0] * (RT_HEADER - 1)
    reals: list = []
    records, coef_start = [], []
    for order_terms in terms:
        coef_start.append(len(reals))
        for coef, m, powers in order_terms:
            reals.append(coef)
            factors = [j for j, e in powers for _ in range(e)]
            records.append((m, len(factors), *factors))
    coef_start.append(len(reals))
    row_starts = {}
    for name, rows in (("tanh", tanh_poly_rows(n)), ("sigmoid", sigmoid_poly_rows(n))):
        row_starts[name] = []
        for row in rows:
            row_starts[name].append(len(reals))
            reals.extend(row)
        row_starts[name].append(len(reals))
    inv_fact = len(reals)
    reals.extend(1.0 / math.factorial(m) for m in range(n + 1))

    ints[RT_COEFS] = len(ints)
    ints += coef_start
    ints[RT_TANH] = len(ints)
    ints += row_starts["tanh"]
    ints[RT_SIGMOID] = len(ints)
    ints += row_starts["sigmoid"]
    ints[RT_RECORDS] = len(ints)
    ints += [0] * (n + 1)
    for k in range(n):
        ints[ints[RT_RECORDS] + k] = len(ints)
        first = sum(len(t) for t in terms[:k])
        for rec in records[first:first + len(terms[k])]:
            ints += rec
    ints[ints[RT_RECORDS] + n] = len(ints)
    ints[RT_INV_FACT] = inv_fact
    return tuple(ints), tuple(float(r) for r in reals)


# ---------------------------------------------------------------------------
# csrc/fdb_tables.cuh: the same tables as straight-line CUDA code
# ---------------------------------------------------------------------------

HEADER_ORDER = 8              # the templated kernels' orders (N1 <= 9); above, jet_runtime.cu
HEADER_NAME = "fdb_tables.cuh"


def _literal(c: float) -> str:
    """A C++ literal that parses back to the same float64 (Python's repr
    round-trips), wrapped in T(.) so float kernels take it as float."""
    text = repr(float(c))
    if "e" not in text and "." not in text:
        text += ".0"
    return f"T({text})"


def _horner(row) -> str:
    """Horner's rule in ``u`` over ``row`` (low -> high), the evaluation
    order of ref.py::_taylor_stack."""
    expr = _literal(row[-1])
    for c in row[-2::-1]:
        expr = f"add(mul({expr}, u), {_literal(c)})"
    return expr


def _term(coef: float, m: int, powers) -> str:
    """C_p F_m prod_j z_j^{p_j}, multiplied left to right as ref.py does."""
    factors = [f"f[{m}]"] + ([] if coef == 1.0 else [_literal(coef)])
    for j, e in powers:
        factors += [f"z[{j}]"] * e
    expr = factors[0]
    for factor in factors[1:]:
        expr = f"mul({expr}, {factor})"
    return expr


def cuda_header(n: int = HEADER_ORDER) -> str:
    """Text of csrc/fdb_tables.cuh: the Faa di Bruno terms of orders 1..n
    and the tanh / sigmoid Horner rows 0..n as straight-line device code,
    so the kernels' epilogue reads no table and runs no data-dependent
    loop.  ``python -m repro_torch.kernels.bell_tables`` rewrites it."""
    out = [
        "// Generated by `python -m repro_torch.kernels.bell_tables` from",
        "// kernels/bell_tables.py (fdb_terms, tanh_poly_rows, sigmoid_poly_rows),",
        f"// orders 1..{n}.  Do not edit: tests/test_torch_tables.py holds it equal",
        "// to the generator and decodes it back to the tables.",
        "//",
        "// fdb_order_k(f, z) = sum_{p in P(k)} C_p F_|p| prod_j z_j^{p_j}, one term",
        "// per line in fdb_terms order; tanh_row_m(u) / sigmoid_row_m(u) = F_m by",
        "// Horner's rule in u.  Every index is a constant, so once inlined the",
        "// arrays f and z stay in registers.  Each product and sum is rounded on",
        "// its own, in the order ref.py's separate PyTorch ops round them (no",
        "// FMA contraction): at order 8 the sigmoid rows cancel enough that",
        "// contracting them moves the result by more than 1e-12 of its size.",
        "#pragma once",
        "",
        "namespace jetk {",
        "namespace fdb {",
        "",
        f"constexpr int kMaxOrder = {n};",
        "",
        "__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }",
        "__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }",
        "__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }",
        "__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }",
    ]
    for k, terms in enumerate(fdb_terms(n), start=1):
        out += ["", f"// order {k}: {len(terms)} term" + "s" * (len(terms) > 1), "template <typename T>",
                f"__device__ __forceinline__ T fdb_order_{k}(const T* f, const T* z) {{",
                f"  T acc = {_term(*terms[0])};"]
        out += [f"  acc = add(acc, {_term(*t)});" for t in terms[1:]]
        out += ["  return acc;", "}"]
    for name, rows in (("tanh", tanh_poly_rows(n)), ("sigmoid", sigmoid_poly_rows(n))):
        for m, row in enumerate(rows):
            out += ["", "template <typename T>",
                    f"__device__ __forceinline__ T {name}_row_{m}(T u) {{",
                    f"  return {_horner(row)};", "}"]
    # N1-templated entry points: out[0..N1) and f[0..N1); the discarded
    # branches are never instantiated
    out += ["", "// out[k] for k < N1; out[0] = F_0",
            "template <typename T, int N1>",
            "__device__ __forceinline__ void faa_di_bruno(const T* f, const T* z, T* out) {",
            "  out[0] = f[0];"]
    out += [f"  if constexpr (N1 > {k}) out[{k}] = fdb_order_{k}(f, z);"
            for k in range(1, n + 1)]
    out += ["}"]
    for name in ("tanh", "sigmoid"):
        out += ["", f"// f[m] = {name}^(m)(z_0) / m! for m < N1, from u",
                "template <typename T, int N1>",
                f"__device__ __forceinline__ void {name}_rows(T u, T* f) {{",
                f"  f[0] = {name}_row_0(u);"]
        out += [f"  if constexpr (N1 > {m}) f[{m}] = {name}_row_{m}(u);"
                for m in range(1, n + 1)]
        out += ["}"]
    out += ["", "}  // namespace fdb", "}  // namespace jetk", ""]
    return "\n".join(out)


if __name__ == "__main__":
    from pathlib import Path

    target = Path(__file__).resolve().parent / "csrc" / HEADER_NAME
    target.write_text(cuda_header())
    print(f"wrote {target}")
