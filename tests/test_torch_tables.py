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


def _decode_runtime_table(n):
    """runtime_table(n) read back as the run-time kernels read it:
    (fdb_terms, tanh rows, sigmoid rows, 1/m!)."""
    ints, reals = tbell.runtime_table(n)
    assert ints[tbell.RT_ORDER] == n
    recs, coefs = ints[tbell.RT_RECORDS], ints[tbell.RT_COEFS]
    terms = []
    for k in range(1, n + 1):
        p, t, order_terms = ints[recs + k - 1], ints[coefs + k - 1], []
        while p < ints[recs + k]:
            m, cnt = ints[p], ints[p + 1]
            js = ints[p + 2:p + 2 + cnt]
            powers = tuple((j, js.count(j)) for j in dict.fromkeys(js))
            order_terms.append((reals[t], m, powers))
            p, t = p + 2 + cnt, t + 1
        assert t == ints[coefs + k]
        terms.append(tuple(order_terms))
    rows = {}
    for name, pos in (("tanh", tbell.RT_TANH), ("sigmoid", tbell.RT_SIGMOID)):
        starts = ints[ints[pos]:ints[pos] + n + 2]
        rows[name] = tuple(reals[starts[m]:starts[m + 1]] for m in range(n + 1))
    inv = reals[ints[tbell.RT_INV_FACT]:ints[tbell.RT_INV_FACT] + n + 1]
    return tuple(terms), rows["tanh"], rows["sigmoid"], inv


@pytest.mark.parametrize("n", [1, 8, 10, 16])
def test_runtime_table_decodes_to_the_tables(n):
    """The data the run-time-order kernels (csrc/jet_runtime.cu) read
    decodes back to fdb_terms, the Horner rows and 1/m!, exactly; orders
    1..16 hold 914 terms."""
    terms, tanh_rows, sigmoid_rows, inv = _decode_runtime_table(n)
    assert terms == tbell.fdb_terms(n)
    assert tanh_rows == tbell.tanh_poly_rows(n)
    assert sigmoid_rows == tbell.sigmoid_poly_rows(n)
    assert inv == tuple(1.0 / math.factorial(m) for m in range(n + 1))
    if n == 16:
        assert sum(len(t) for t in terms) == 914


def _runtime_epilogue(z, activation):
    """csrc/jet_runtime.cu::act_jet_runtime in plain torch: the table walked
    record by record, the output orders from the highest down, each stored
    over its input coefficient."""
    n = z.shape[0] - 1
    ints, reals = tbell.runtime_table(n)
    z = [c.clone() for c in z]
    if activation == "sin":
        s, c = torch.sin(z[0]), torch.cos(z[0])
        inv = ints[tbell.RT_INV_FACT]
        f = [(s, c, -s, -c)[m % 4] * reals[inv + m] for m in range(n + 1)]
    else:
        u = torch.tanh(z[0]) if activation == "tanh" else 0.5 * (torch.tanh(0.5 * z[0]) + 1.0)
        rows = ints[ints[tbell.RT_TANH if activation == "tanh" else tbell.RT_SIGMOID]:][:n + 2]
        f = []
        for m in range(n + 1):
            acc = torch.full_like(u, reals[rows[m + 1] - 1])
            for i in range(rows[m + 1] - 2, rows[m] - 1, -1):
                acc = acc * u + reals[i]
            f.append(acc)
    recs, coefs = ints[tbell.RT_RECORDS], ints[tbell.RT_COEFS]
    for k in range(n, 0, -1):
        p, t, acc = ints[recs + k - 1], ints[coefs + k - 1], None
        while p < ints[recs + k]:
            m, cnt = ints[p], ints[p + 1]
            prod = f[m] * reals[t]
            for j in ints[p + 2:p + 2 + cnt]:
                prod = prod * z[j]
            acc = prod if acc is None else acc + prod
            p, t = p + 2 + cnt, t + 1
        z[k] = acc
    z[0] = f[0]
    return torch.stack(z)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "sin"])
@pytest.mark.parametrize("n", [4, 10, 12])
def test_runtime_epilogue_walk_equals_the_plain_version(activation, n):
    """The run-time kernels' in-place walk of the table rounds as ref.py:
    bit for bit in float64."""
    from repro_torch.kernels import ref as tref
    z = torch.tensor(np.random.default_rng(n).normal(size=(n + 1, 6, 5)) * 0.5)
    assert torch.equal(_runtime_epilogue(z, activation), tref.act_jet_ref(z, activation))


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
