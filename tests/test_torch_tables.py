"""The port's static tables against the JAX package's: integer partitions,
Faa di Bruno terms, derivative polynomials, the kernels' coefficient rows,
the Taylor stacks and primals, and the generated header the CUDA kernels
compile (csrc/fdb_tables.cuh).

Tables are exact integers or their float images, so they must be EQUAL;
the Taylor stacks and primals are floating point and agree at f64 to
1e-12 relative (the two libraries' tanh/sin differ in the last ulp)."""

import importlib
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
    assert sorted(orders) == list(range(1, tanh_jet.MAX_ORDER + 1))
    for k, order_terms in enumerate(tbell.fdb_terms(tanh_jet.MAX_ORDER), 1):
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
    assert tbell.HEADER_ORDER == tanh_jet.MAX_ORDER


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
