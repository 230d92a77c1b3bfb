"""The port's jet algebra (repro_torch.core.jet) against the JAX package's
(repro.core.jet) on identical float64 inputs, orders 0-6.

Both sides compute the same power-series identities in the same operation
order, so they agree to rounding: rtol 1e-12 and atol 1e-12 x max|ref|
(the two libraries' tanh/sin/einsum differ in the last few ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import jet as JJ
from repro_torch.core import jet as TJ

ORDERS = range(7)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * max(np.abs(want).max(), 1e-300))


def _stack(order, shape, seed, scale=0.7):
    return np.random.default_rng(seed).normal(size=(order + 1,) + shape) * scale


def _pair(order, shape=(3, 4), seed=0):
    c = _stack(order, shape, seed)
    return TJ.Jet(torch.tensor(c)), JJ.Jet(jnp.asarray(c))


@pytest.mark.parametrize("order", ORDERS)
def test_seed_const_derivatives_roundtrip(order):
    rng = np.random.default_rng(order)
    x, v = rng.normal(size=(5, 2)), rng.normal(size=(5, 2))
    if order >= 1:
        _close(TJ.seed(torch.tensor(x), torch.tensor(v), order).coeffs,
               JJ.seed(jnp.asarray(x), jnp.asarray(v), order).coeffs)
        _close(TJ.seed(torch.tensor(x), None, order).coeffs,
               JJ.seed(jnp.asarray(x), None, order).coeffs)
    _close(TJ.const(torch.tensor(x), order).coeffs,
           JJ.const(jnp.asarray(x), order).coeffs)
    t, j = _pair(order)
    _close(TJ.derivatives(t), JJ.derivatives(j))
    _close(TJ.from_derivatives(TJ.derivatives(t)).coeffs, t.coeffs)
    _close(TJ.from_derivatives(TJ.derivatives(t)).coeffs,
           JJ.from_derivatives(JJ.derivatives(j)).coeffs)


@pytest.mark.parametrize("order", ORDERS)
def test_add_sub_scale_mul(order):
    ta, ja = _pair(order, seed=1)
    tb, jb = _pair(order, seed=2)
    _close(TJ.add(ta, tb).coeffs, JJ.add(ja, jb).coeffs)
    _close(TJ.sub(ta, tb).coeffs, JJ.sub(ja, jb).coeffs)
    _close(TJ.add(ta, 1.5).coeffs, JJ.add(ja, 1.5).coeffs)
    _close((2.0 - ta).coeffs, (2.0 - ja).coeffs)
    _close(TJ.scale(ta, 0.3).coeffs, JJ.scale(ja, 0.3).coeffs)
    _close(TJ.mul(ta, tb).coeffs, JJ.mul(ja, jb).coeffs)
    _close((ta * 3.0).coeffs, (ja * 3.0).coeffs)
    _close((-ta).coeffs, (-ja).coeffs)


@pytest.mark.parametrize("order", ORDERS)
def test_broadcast_alignment(order):
    """_align inserts singleton axes after the coefficient axis."""
    ta, ja = _pair(order, shape=(2, 3, 4), seed=3)
    tb, jb = _pair(order, shape=(4,), seed=4)
    _close(TJ.mul(ta, tb).coeffs, JJ.mul(ja, jb).coeffs)
    _close(TJ.add(tb, ta).coeffs, JJ.add(jb, ja).coeffs)


@pytest.mark.parametrize("order", ORDERS)
def test_linear_bias_on_c0_only(order):
    rng = np.random.default_rng(10 + order)
    w, b = rng.normal(size=(4, 6)), rng.normal(size=(6,))
    t, j = _pair(order, shape=(2, 3, 4), seed=5)
    _close(TJ.linear(t, torch.tensor(w), torch.tensor(b)).coeffs,
           JJ.linear(j, jnp.asarray(w), jnp.asarray(b)).coeffs)
    _close(TJ.linear(t, torch.tensor(w)).coeffs,
           JJ.linear(j, jnp.asarray(w)).coeffs)
    shift = (TJ.linear(t, torch.tensor(w), torch.tensor(b)).coeffs
             - TJ.linear(t, torch.tensor(w)).coeffs)
    _close(shift[0], np.broadcast_to(b, shift.shape[1:]))
    assert torch.equal(shift[1:], torch.zeros_like(shift[1:]))


@pytest.mark.parametrize("name", ["tanh", "sigmoid", "softplus", "sin", "exp"])
@pytest.mark.parametrize("order", ORDERS)
def test_compose_table_activations(name, order):
    t, j = _pair(order, seed=20 + order)
    _close(TJ.compose(t, name).coeffs, JJ.compose(j, name).coeffs)
    _close(TJ.activation(t, name).coeffs, JJ.activation(j, name).coeffs)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "identity"])
@pytest.mark.parametrize("order", (0, 3, 6))
def test_composite_activations(name, order):
    t, j = _pair(order, seed=30 + order)
    _close(TJ.activation(t, name).coeffs, JJ.activation(j, name).coeffs)


def test_named_activation_helpers_and_errors():
    t, j = _pair(4, seed=40)
    for name in ("tanh", "sigmoid", "sin", "softplus", "silu", "gelu", "relu",
                 "identity"):
        _close(getattr(TJ, name)(t).coeffs, getattr(JJ, name)(j).coeffs)
    with pytest.raises(KeyError):
        TJ.activation(t, "nope")
    with pytest.raises(ValueError):
        TJ.add(t, _pair(3)[0])


@pytest.mark.parametrize("order", (1, 4))
def test_where_and_jmap(order):
    t, j = _pair(order, seed=50)
    mask = np.random.default_rng(5).random((3, 4)) > 0.5
    _close(TJ.where(torch.tensor(mask), t, 0.5).coeffs,
           JJ.where(jnp.asarray(mask), j, 0.5).coeffs)
    _close(TJ.jmap(lambda c: c.sum(-1), t).coeffs,
           JJ.jmap(lambda c: c.sum(-1), j).coeffs)


def test_jet_accessors():
    t, j = _pair(3, shape=(2, 5))
    assert t.order == j.order == 3
    assert t.shape == tuple(j.shape) == (2, 5)
    assert t.dtype == torch.float64
    _close(t.primal, j.primal)


# ---------------------------------------------------------------------------
# log and layer_norm: port against the reference op, and both against
# jax.experimental.jet's pushforward (the oracle of tests/test_engines.py)
# ---------------------------------------------------------------------------

def _jet_oracle(fn, *coeff_stacks):
    """Raw derivatives of fn pushed through jax.experimental.jet."""
    from jax.experimental import jet as jjet
    raws = [np.asarray(JJ.derivatives(JJ.Jet(jnp.asarray(c)))) for c in coeff_stacks]
    y0, ys = jjet.jet(fn, tuple(jnp.asarray(r[0]) for r in raws),
                      tuple([jnp.asarray(x) for x in r[1:]] for r in raws))
    return np.stack([np.asarray(y0)] + [np.asarray(y) for y in ys])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("order", range(1, 7))
def test_log_matches_reference_and_jax_jet(order, seed):
    c = _stack(order, (3, 4), 100 + seed)
    c[0] = np.abs(c[0]) + 1.0
    got = TJ.log(TJ.Jet(torch.tensor(c)))
    _close(got.coeffs, JJ.log(JJ.Jet(jnp.asarray(c))).coeffs)
    np.testing.assert_allclose(TJ.derivatives(got).numpy(), _jet_oracle(jnp.log, c),
                               rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("order", range(0, 7))
def test_layer_norm_matches_reference_and_jax_jet(order, seed):
    c = _stack(order, (5, 6), 200 + seed)
    rng = np.random.default_rng(300 + seed)
    gamma, beta = rng.normal(size=(6,)) + 1.0, rng.normal(size=(6,)) * 0.1
    got = TJ.layer_norm(TJ.Jet(torch.tensor(c)), torch.tensor(gamma), torch.tensor(beta))
    _close(got.coeffs, JJ.layer_norm(JJ.Jet(jnp.asarray(c)), jnp.asarray(gamma),
                                     jnp.asarray(beta)).coeffs)
    if order == 0:
        return

    def ln(x):
        mu = x.mean(-1, keepdims=True)
        return (x - mu) / jnp.sqrt(x.var(-1, keepdims=True) + 1e-5) * gamma + beta

    np.testing.assert_allclose(TJ.derivatives(got).numpy(), _jet_oracle(ln, c),
                               rtol=1e-8, atol=1e-9)
