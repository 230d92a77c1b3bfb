"""The port's static tables against the JAX package's: integer partitions,
Faa di Bruno terms, derivative polynomials, the kernels' coefficient rows,
the Taylor stacks and primals, and the packed buffer the CUDA kernels read.

Tables are exact integers or their float images, so they must be EQUAL;
the Taylor stacks and primals are floating point and agree at f64 to
1e-12 relative (the two libraries' tanh/sin differ in the last ulp)."""

import importlib

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


def test_packed_device_tables_decode_to_fdb_terms():
    """The buffer the CUDA kernels read (csrc/act_jet.cuh::Tables) decodes
    back to fdb_terms and the poly rows exactly, for every order <= 8."""
    ints, vals, n_terms = tanh_jet._host_tables()
    n1 = tanh_jet.MAX_ORDER + 1
    starts, terms = ints[:n1], ints[n1:].reshape(-1, 2)
    assert starts[0] == 0 and starts[-1] == n_terms == len(terms)
    coef, poly = vals[:n_terms], vals[n_terms:].reshape(2, n1, n1 + 1)
    for k, order_terms in enumerate(tbell.fdb_terms(tanh_jet.MAX_ORDER), 1):
        lo, hi = starts[k - 1], starts[k]
        decoded = []
        for t in range(lo, hi):
            m, packed = int(terms[t, 0]), int(terms[t, 1])
            powers = tuple((j, (packed >> (4 * (j - 1))) & 0xF)
                           for j in range(1, n1) if (packed >> (4 * (j - 1))) & 0xF)
            decoded.append((float(coef[t]), m, powers))
        assert tuple(decoded) == order_terms
    for block, rows in enumerate((tbell.tanh_poly_rows(8), tbell.sigmoid_poly_rows(8))):
        for m, row in enumerate(rows):
            np.testing.assert_array_equal(poly[block, m, :len(row)], row)
            assert not poly[block, m, len(row):].any()


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
