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

# Header of runtime_table's int array: the order, the number of slots, then
# where each section starts (csrc/jet_runtime.cu reads the same positions).
(RT_ORDER, RT_SLOTS, RT_SLOT_START, RT_SLOT_ORDERS, RT_ORDER_RECORDS, RT_RECORDS,
 RT_TANH, RT_SIGMOID, RT_INV_FACT) = range(9)
RT_HEADER = 9
# A term is a record of 4 ints (one 16-byte load): its part count m, its
# parts z_1 .. z_RT_LOW_PARTS counted 8 bits a part (the kernels keep those
# coefficients in registers), the count of its larger parts, and the first
# RT_INLINE_PARTS of them 8 bits each, so that the kernels' loads of their
# coefficients wait for the record alone (more, past order 24, are
# listed).  Orders past 255 would overflow the 8-bit fields.
RT_LOW_PARTS = 4
RT_INLINE_PARTS = 4
RT_RECORD_INTS = 4
RT_MAX_ORDER = 255
# both arrays are padded to whole 16-byte pieces, which the kernels copy
# into shared memory with 16-byte cp.async copies
RT_INT_ALIGN, RT_REAL_ALIGN = 4, 2


@lru_cache(maxsize=None)
def order_slots(n: int) -> Tuple[Tuple[int, ...], ...]:
    """The output orders 1..n grouped into slots, one slot a thread of the
    run-time dense epilogue: first-fit decreasing by term count p(k), with
    room p(n) (the largest), so that no slot sums more terms than order n
    alone and the critical path is p(n) terms instead of sum_k p(k)."""
    counts = {k: len(t) for k, t in enumerate(fdb_terms(n), start=1)}
    room = max(counts.values(), default=0)
    slots: list = []          # [terms, [orders]]
    for k in sorted(counts, key=lambda k: (-counts[k], k)):
        slot = next((s for s in slots if s[0] + counts[k] <= room), None)
        if slot is None:
            slots.append([counts[k], [k]])
        else:
            slot[0] += counts[k]
            slot[1].append(k)
    return tuple(tuple(orders) for _, orders in slots)


@lru_cache(maxsize=None)
def runtime_table(n: int) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    """The epilogue's tables for orders 1..n as two flat arrays ``(ints,
    reals)``, for the run-time-order kernels: a schedule whose every load
    address follows from loop counters, never from a loaded count.

    ``ints[:RT_HEADER]`` is the order, the slot count S and the start of
    each section.  Slot s (:func:`order_slots`) holds the orders
    ``slot_orders[slot_start[s]:slot_start[s + 1]]``.  Faa di Bruno terms
    are numbered r = 0.. order by order, each order in fdb_terms' order:
    order k's are ``order_records[k - 1] <= r < order_records[k]``.  Term r
    is ``reals[r] F_m z_1^e_1 .. z_4^e_4 prod_i z_{j_i}``, multiplied in
    that order (ref.py's: parts ascending); its record ``records[4 r:4 r +
    4]`` is (m, e_1..e_4, h + 256 start, j_1..j_4), the e and j packed 8
    bits each, lowest first: m the count of all parts, h of the larger
    parts j_1..j_h, the first four inline (0 past the last), the rest at
    ``ints[start:start + h - 4]``.
    ``ints[ints[RT_TANH] + m]`` (m = 0..n+1) bound Horner row m of tanh
    in ``reals`` (low -> high), likewise ``RT_SIGMOID``;
    ``reals[ints[RT_INV_FACT] + m]`` is 1 / m!, the sin stack's factor.
    Both arrays end in zeros up to whole 16-byte pieces."""
    if n > RT_MAX_ORDER:
        raise ValueError(f"the run-time table counts parts in 8 bits: order {n} > "
                         f"{RT_MAX_ORDER}")
    terms = fdb_terms(n)
    slots = order_slots(n)
    reals = [coef for order_terms in terms for coef, _, _ in order_terms]
    row_starts = {}
    for name, rows in (("tanh", tanh_poly_rows(n)), ("sigmoid", sigmoid_poly_rows(n))):
        row_starts[name] = []
        for row in rows:
            row_starts[name].append(len(reals))
            reals.extend(row)
        row_starts[name].append(len(reals))
    inv_fact = len(reals)
    reals.extend(1.0 / math.factorial(m) for m in range(n + 1))

    ints = [0] * RT_HEADER
    ints[RT_ORDER], ints[RT_SLOTS], ints[RT_INV_FACT] = n, len(slots), inv_fact
    ints[RT_SLOT_START] = len(ints)
    ints += [sum(map(len, slots[:s])) for s in range(len(slots) + 1)]
    ints[RT_SLOT_ORDERS] = len(ints)
    ints += [k for orders in slots for k in orders]
    ints[RT_ORDER_RECORDS] = len(ints)
    ints += [sum(map(len, terms[:k])) for k in range(n + 1)]
    for name, pos in (("tanh", RT_TANH), ("sigmoid", RT_SIGMOID)):
        ints[pos] = len(ints)
        ints += row_starts[name]
    ints += [0] * (-len(ints) % RT_INT_ALIGN)          # records load 16 bytes at once
    ints[RT_RECORDS] = len(ints)
    records = [(m, powers) for order_terms in terms for _, m, powers in order_terms]
    at = len(ints) + RT_RECORD_INTS * len(records)
    high = [[j for j, e in powers if j > RT_LOW_PARTS for _ in range(e)]
            for _, powers in records]
    for (m, powers), js in zip(records, high):
        counts = dict(powers)
        assert sum(counts.values()) == m, "a term's part count is its F order"
        ints += [m, sum(counts.get(j, 0) << (8 * (j - 1)) for j in range(1, RT_LOW_PARTS + 1)),
                 len(js) + (at << 8),
                 sum(j << (8 * i) for i, j in enumerate(js[:RT_INLINE_PARTS]))]
        at += max(0, len(js) - RT_INLINE_PARTS)
    for js in high:
        ints += js[RT_INLINE_PARTS:]
    ints += [0] * (-len(ints) % RT_INT_ALIGN)
    reals += [0.0] * (-len(reals) % RT_REAL_ALIGN)
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
