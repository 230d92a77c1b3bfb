"""The port's static tables against the JAX package's: integer partitions,
Faa di Bruno terms, derivative polynomials, the kernels' coefficient rows,
the Taylor stacks and primals, and the generated header the CUDA kernels
compile (csrc/fdb_tables.cuh).

Tables are exact integers or their float images, so they must be EQUAL;
the Taylor stacks and primals are floating point and agree at f64 to
1e-12 relative (the two libraries' tanh/sin differ in the last ulp)."""

import importlib
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import activations as jact
from repro.kernels import bell_tables as jbell
from repro_torch.core import activations as tact
from repro_torch.kernels import bell_tables as tbell
from repro_torch.kernels import tanh_jet
from repro_torch.tree import bit_equal

# the packages' __init__ re-export a function named `partitions`, which
# shadows the submodule as an attribute
jpart = importlib.import_module("repro.core.partitions")
tpart = importlib.import_module("repro_torch.core.partitions")

KS = range(13)


@pytest.mark.parametrize("k", KS)
def test_partitions_equal(k):
    assert tpart.partitions(k) == jpart.partitions(k)
    assert tpart.partition_count(k) == jpart.partition_count(k)
    assert tpart.bell_number(k) == jpart.bell_number(k)
    assert tpart.total_fdb_terms(k) == jpart.total_fdb_terms(k)


@pytest.mark.parametrize("k", range(1, 13))
def test_faa_di_bruno_table_equal_term_for_term(k):
    assert tpart.faa_di_bruno_table(k) == jpart.faa_di_bruno_table(k)
    for part in tpart.partitions(k):
        assert tpart.raw_bell_coefficient(part, k) == \
            jpart.raw_bell_coefficient(part, k)


@pytest.mark.parametrize("fn", ["tanh_derivative_polys",
                                "sigmoid_derivative_polys"])
def test_derivative_polys_equal(fn):
    assert getattr(tact, fn)(12) == getattr(jact, fn)(12)
    np.testing.assert_array_equal(tact.poly_table_f32(getattr(tact, fn)(12)),
                                  jact.poly_table_f32(getattr(jact, fn)(12)))


@pytest.mark.parametrize("fn", ["tanh_poly_rows", "sigmoid_poly_rows",
                                "fdb_terms"])
def test_kernel_tables_equal(fn):
    for n in (1, 4, 8, 12):
        assert getattr(tbell, fn)(n) == getattr(jbell, fn)(n)


def test_flop_estimate_equal():
    for n in (1, 4, 8):
        assert tbell.flop_estimate(n, 16, 32) == jbell.flop_estimate(n, 16, 32)


def _header() -> str:
    return (Path(tbell.__file__).parent / "csrc" / tbell.HEADER_NAME).read_text()


def _function_bodies(text: str, prefix: str) -> dict:
    """{index: body} of the header's functions ``<prefix><index>(...)``."""
    pat = re.compile(r"T " + prefix + r"(\d+)\([^)]*\) \{\n(.*?)\n\}", re.S)
    return {int(m.group(1)): m.group(2) for m in pat.finditer(text)}


def _literals(expr: str) -> list:
    return [float(c) for c in re.findall(r"T\(([-0-9.e+]+)\)", expr)]


def test_packed_device_tables_decode_to_fdb_terms():
    """The tables the CUDA kernels read, now straight-line code in
    csrc/fdb_tables.cuh, decode back to fdb_terms and the Horner rows
    exactly, for every order <= 8."""
    text = _header()
    orders = _function_bodies(text, "fdb_order_")
    assert sorted(orders) == list(range(1, tbell.HEADER_ORDER + 1))
    for k, order_terms in enumerate(tbell.fdb_terms(tbell.HEADER_ORDER), 1):
        decoded = []
        for line in orders[k].splitlines()[:-1]:          # the last is `return acc;`
            expr = line.split("=", 1)[1].strip().rstrip(";")
            m = int(re.search(r"f\[(\d+)\]", expr).group(1))
            coef = _literals(expr)
            js = [int(j) for j in re.findall(r"z\[(\d+)\]", expr)]
            powers = tuple((j, js.count(j)) for j in sorted(set(js)))
            decoded.append((coef[0] if coef else 1.0, m, powers))
        assert tuple(decoded) == order_terms
    for name, rows in (("tanh", tbell.tanh_poly_rows(8)),
                       ("sigmoid", tbell.sigmoid_poly_rows(8))):
        bodies = _function_bodies(text, f"{name}_row_")
        assert sorted(bodies) == list(range(9))
        for m, row in enumerate(rows):
            assert tuple(_literals(bodies[m])[::-1]) == row


def test_kernel_header_is_generated_from_the_tables():
    """csrc/fdb_tables.cuh is exactly what bell_tables.cuda_header writes
    (regenerate with ``python -m repro_torch.kernels.bell_tables``), and
    covers the kernels' template limit."""
    assert _header() == tbell.cuda_header()
    assert tbell.HEADER_ORDER + 1 == tanh_jet.TEMPLATE_N1


def _record(ints, r):
    """Term r's record: (m, [e_1..e_4], its larger parts): the first four
    inline, zero past the last, the rest listed."""
    m, low, where, packed = ints[ints[tbell.RT_RECORDS] + tbell.RT_RECORD_INTS * r:][:4]
    counts = [(low >> (8 * i)) & 255 for i in range(tbell.RT_LOW_PARTS)]
    inline = [(packed >> (8 * i)) & 255 for i in range(tbell.RT_INLINE_PARTS)]
    h, start = where & 255, where >> 8
    assert inline[h:] == [0] * max(0, tbell.RT_INLINE_PARTS - h)
    return m, counts, tuple(inline[:h]) + ints[start:start + h - tbell.RT_INLINE_PARTS]


def _decode_runtime_table(n):
    """runtime_table(n) read back as the run-time kernels read it:
    (fdb_terms, tanh rows, sigmoid rows, 1/m!, slots)."""
    ints, reals = tbell.runtime_table(n)
    assert ints[tbell.RT_ORDER] == n
    assert len(ints) % tbell.RT_INT_ALIGN == 0 and len(reals) % tbell.RT_REAL_ALIGN == 0
    first = ints[tbell.RT_ORDER_RECORDS]
    assert ints[tbell.RT_RECORDS] % 4 == 0              # 16-byte loads
    terms = []
    for k in range(1, n + 1):
        order_terms = []
        for r in range(ints[first + k - 1], ints[first + k]):
            m, counts, high = _record(ints, r)
            assert all(j > tbell.RT_LOW_PARTS for j in high)
            js = [j for j, e in enumerate(counts, start=1) for _ in range(e)] + list(high)
            assert m == len(js)
            powers = tuple((j, js.count(j)) for j in dict.fromkeys(js))
            order_terms.append((reals[r], m, powers))
        terms.append(tuple(order_terms))
    rows = {}
    for name, pos in (("tanh", tbell.RT_TANH), ("sigmoid", tbell.RT_SIGMOID)):
        starts = ints[ints[pos]:ints[pos] + n + 2]
        rows[name] = tuple(reals[starts[m]:starts[m + 1]] for m in range(n + 1))
    inv = reals[ints[tbell.RT_INV_FACT]:ints[tbell.RT_INV_FACT] + n + 1]
    start, orders = ints[tbell.RT_SLOT_START], ints[tbell.RT_SLOT_ORDERS]
    slots = tuple(tuple(ints[orders + i] for i in range(ints[start + s], ints[start + s + 1]))
                  for s in range(ints[tbell.RT_SLOTS]))
    return tuple(terms), rows["tanh"], rows["sigmoid"], inv, slots


@pytest.mark.parametrize("n", [0, 1, 4, 8, 9, 10, 12, 16, 26])
def test_runtime_table_decodes_to_the_tables(n):
    """The data the run-time-order kernels (csrc/jet_runtime.cu) read
    decodes back to fdb_terms, the Horner rows, 1/m! and the slot
    schedule, exactly (the parts 1-4 counted, the larger ones inline and,
    from order 25, the fifth on listed); a
    term's part count is its F order, which is how the kernel reads m;
    orders 1..16 hold 914 terms."""
    terms, tanh_rows, sigmoid_rows, inv, slots = _decode_runtime_table(n)
    assert terms == tbell.fdb_terms(n)
    assert tanh_rows == tbell.tanh_poly_rows(n)
    assert sigmoid_rows == tbell.sigmoid_poly_rows(n)
    assert inv == tuple(1.0 / math.factorial(m) for m in range(n + 1))
    assert slots == tbell.order_slots(n)
    if n == 16:
        assert sum(len(t) for t in terms) == 914


def test_runtime_table_refuses_orders_its_counts_cannot_hold():
    with pytest.raises(ValueError, match="8 bits: order 256 > 255"):
        tbell.runtime_table(tbell.RT_MAX_ORDER + 1)


@pytest.mark.parametrize("n", list(range(17)) + [20])
def test_order_slots_cover_every_order_once_within_the_largest(n):
    """Every output order 1..n is in exactly one slot, and no slot sums more
    terms than order n alone, p(n) = max_k p(k): the critical path of the
    epilogue falls from sum_k p(k) terms (138 at order 10, 914 at 16) to
    p(n) (42, 231), over 4 slots from order 9 to 16."""
    slots = tbell.order_slots(n)
    assert sorted(k for slot in slots for k in slot) == list(range(1, n + 1))
    counts = [len(t) for t in tbell.fdb_terms(n)]
    per_slot = [sum(counts[k - 1] for k in slot) for slot in slots]
    assert max(per_slot, default=0) == max(counts, default=0)
    assert len(slots) >= math.ceil(sum(counts) / max(counts, default=1))
    if 9 <= n <= 16:
        assert len(slots) == 4
    if n in (10, 16):
        assert (max(per_slot), sum(counts)) == {10: (42, 138), 16: (231, 914)}[n]


def _runtime_epilogue(z, activation):
    """csrc/jet_runtime.cu's dense epilogue in plain torch, as the kernel
    runs it: the primal into F_0 and out_0, the Horner rows of F (each
    coefficient rounded to the compute type first), then per slot of the
    schedule, per order of the slot, its terms r summed one by one from
    zero, each read from its 4-int record: m, the parts z_1..z_4 counted,
    the larger ones (the first four inline, the rest listed)."""
    if activation is None:
        return z.clone()
    n = z.shape[0] - 1
    ints, reals = tbell.runtime_table(n)

    def real(i):
        return torch.tensor(reals[i], dtype=z.dtype)

    def horner(rows, m, u):
        lo, hi = ints[rows + m], ints[rows + m + 1]
        acc = torch.full_like(u, reals[hi - 1])
        for i in range(hi - 2, lo - 1, -1):
            acc = acc * u + real(i)
        return acc

    out = [None] * (n + 1)
    if activation == "sin":
        s, c = torch.sin(z[0]), torch.cos(z[0])
        f = [(s, c, -s, -c)[m % 4] * real(ints[tbell.RT_INV_FACT] + m) for m in range(n + 1)]
        out[0] = f[0]
    else:
        rows = ints[tbell.RT_TANH if activation == "tanh" else tbell.RT_SIGMOID]
        u = torch.tanh(z[0]) if activation == "tanh" else 0.5 * (torch.tanh(0.5 * z[0]) + 1.0)
        out[0] = horner(rows, 0, u)
        f = [u] + [horner(rows, m, u) for m in range(1, n + 1)]
    start, orders = ints[tbell.RT_SLOT_START], ints[tbell.RT_SLOT_ORDERS]
    first = ints[tbell.RT_ORDER_RECORDS]
    for slot in range(ints[tbell.RT_SLOTS]):
        for i in range(ints[start + slot], ints[start + slot + 1]):
            k = ints[orders + i]
            acc = torch.zeros_like(z[0])
            for r in range(ints[first + k - 1], ints[first + k]):
                m, counts, high = _record(ints, r)
                prod = f[m] * real(r)
                for j, e in enumerate(counts, start=1):
                    for _ in range(e):
                        prod = prod * z[j]
                for j in high:
                    prod = prod * z[j]
                acc = acc + prod
            assert out[k] is None, f"order {k} written twice"
            out[k] = acc
    return torch.stack(out)


def test_runtime_epilogue_walk_reads_the_listed_parts():
    """From order 25 a term can have five parts of 5 or more: the walk
    reads those past the fourth from the list, still bit for bit."""
    from repro_torch.kernels import ref as tref
    z = torch.tensor(np.random.default_rng(26).normal(size=(27, 3, 2)) * 0.3)
    assert bit_equal(_runtime_epilogue(z, "tanh"), tref.act_jet_ref(z, "tanh"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "sin", None])
@pytest.mark.parametrize("n", [4, 9, 10, 11, 12, 13, 14, 15, 16])
def test_runtime_epilogue_walk_equals_the_plain_version(activation, n, dtype):
    """The run-time kernels' walk of the table, slot by slot, rounds as
    ref.py: bit for bit in float64 and float32 (without an activation K1
    stores its pre-activations as they are)."""
    from repro_torch.kernels import ref as tref
    z = torch.tensor(np.random.default_rng(n).normal(size=(n + 1, 6, 5)) * 0.5, dtype=dtype)
    want = z if activation is None else tref.act_jet_ref(z, activation)
    assert bit_equal(_runtime_epilogue(z, activation), want)


@pytest.mark.parametrize("name", sorted(tact.TAYLOR_STACKS))
def test_taylor_stacks_match_reference(name):
    a = np.random.default_rng(0).normal(size=(4, 5)) * 1.5
    want = np.asarray(jact.TAYLOR_STACKS[name](a, 6))
    got = tact.TAYLOR_STACKS[name](torch.tensor(a), 6).numpy()
    scale = np.abs(want).reshape(7, -1).max(axis=1)[:, None, None]
    assert np.all(np.abs(got - want) <= 1e-12 * scale), \
        np.abs(got - want).max()


@pytest.mark.parametrize("name", sorted(tact.PRIMALS))
def test_primals_match_reference(name):
    assert set(tact.PRIMALS) == set(jact.PRIMALS)
    a = np.random.default_rng(1).normal(size=(3, 7)) * 2.0
    want = np.asarray(jact.PRIMALS[name](a))
    got = tact.PRIMALS[name](torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
