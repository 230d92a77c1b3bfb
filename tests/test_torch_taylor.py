"""The port's Taylor-mode oracle (``repro_torch.core.taylor``, engine spec
``"jet"``) against the reference's ``jax.experimental.jet`` oracle.

``JetEngine().derivs`` against ``JaxJetEngine().derivs`` on the reference's
engine-test networks (``tests/test_engines.py``: dense, mlp, residual,
fourier, transformer) and a vector-valued MLP, orders 0-4 and 8;
``taylor_jet_derivatives`` against ``jax_jet_derivatives``; the rule-level
checks ``tests/test_engines.py`` runs on the jet algebra, here on the
Taylor rules; every ``PRIMALS`` activation; the spec and its aliases; an
operation without a rule raising.  Float64; tolerance 1e-12 relative to
each order's largest |reference| (1e-8 for the rule-level checks, as the
reference's own).  Parameters come from the JAX init through
``repro_torch.bridge``, inputs from numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import jet as jjet

torch = pytest.importorskip("torch")

from repro.core import baselines as jbase
from repro.core.engines import JaxJetEngine
from repro.core.network import (MLP as JMLP, DenseMLP as JDense,
                                FourierFeatureMLP as JFourier,
                                ResidualMLP as JResidual, Transformer as JTransformer)
from repro_torch import bridge
from repro_torch.core import baselines as tbase
from repro_torch.core import taylor as T
from repro_torch.core.activations import PRIMALS
from repro_torch.core.engines import (DerivativeEngine, EngineSpec, JetEngine,
                                      NTPEngine)
from repro_torch.core.network import (MLP, DenseMLP, FourierFeatureMLP,
                                      ResidualMLP, Transformer, make_network)

TOL = 1e-12
RULE_TOL = dict(rtol=1e-8, atol=1e-9)     # tests/test_engines.py's _check
ORDERS = (0, 1, 2, 3, 4, 8)

# the reference's engine-test networks (tests/test_engines.py NETWORKS),
# plus the vector-valued MLP
NETWORKS = {
    "dense": (JDense(2, 10, 3, 1), DenseMLP(2, 10, 3, 1)),
    "mlp": (JMLP((2, 8, 12, 1)), MLP((2, 8, 12, 1))),
    "residual": (JResidual(2, 10, 2, 1), ResidualMLP(2, 10, 2, 1)),
    "fourier": (JFourier(2, 10, 2, 1, n_features=6),
                FourierFeatureMLP(2, 10, 2, 1, n_features=6)),
    "transformer": (JTransformer(2, 4, 1, 1, n_heads=2), Transformer(2, 4, 1, 1, n_heads=2)),
    "mlp_vector": (JMLP((2, 8, 3)), MLP((2, 8, 3))),
}


def _close(got, want, keep=1, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    lead = want.shape[:keep]
    d = np.abs(got - want).reshape(lead + (-1,)).max(-1)
    s = np.maximum(np.abs(want).reshape(lead + (-1,)).max(-1), 1e-300)
    assert np.all(d <= tol * s), float((d / s).max())


@pytest.fixture(scope="module")
def reference():
    """Per network: port net, port params, inputs, tangent and the
    reference's order-8 JaxJetEngine table (orders 0..8 in one jet call:
    a jet of order k is the first k+1 coefficients of the order-8 one)."""
    rng = np.random.default_rng(1)
    out = {}
    for name, (jnet, tnet) in NETWORKS.items():
        jp = jnet.init(jax.random.PRNGKey(3), dtype=jnp.float64)
        tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")
        x = rng.normal(size=(5, 2))
        v = rng.normal(size=(5, 2))
        table = jax.jit(lambda p, xx, vv, jnet=jnet:
                        JaxJetEngine().derivs(jnet, p, xx, 8, vv))(
            jp, jnp.asarray(x), jnp.asarray(v))
        out[name] = (tnet, tp, x, v, np.asarray(table))
    return out


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_jet_engine_matches_reference_oracle(reference, name, order):
    tnet, tp, x, v, table = reference[name]
    got = JetEngine().derivs(tnet, tp, torch.from_numpy(x), order, torch.from_numpy(v))
    assert got.shape == (order + 1, x.shape[0], tnet.d_out)
    _close(got, table[:order + 1])


@pytest.mark.parametrize("activation", sorted(PRIMALS))
def test_every_activation_against_the_reference_oracle(activation):
    """softplus against the reference's ntp engine: jax.experimental.jet
    has no rule for its custom_jvp (logaddexp) and leaks a tracer."""
    from repro.core.engines import NTPEngine as JNTP
    jnet = JDense(2, 6, 2, 1, activation=activation)
    tnet = DenseMLP(2, 6, 2, 1, activation=activation)
    jp = jnet.init(jax.random.PRNGKey(5), dtype=jnp.float64)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(2).normal(size=(7, 2))
    oracle = JNTP("jnp") if activation == "softplus" else JaxJetEngine()
    want = oracle.derivs(jnet, jp, jnp.asarray(x), 6)
    got = JetEngine().derivs(tnet, tp, torch.from_numpy(x), 6)
    _close(got, want)


@pytest.mark.parametrize("order", (0, 3, 6))
def test_taylor_jet_derivatives_matches_jax_jet_derivatives(order):
    from repro.core.ntp import init_mlp as jinit
    jp = jinit(jax.random.PRNGKey(0), 2, 12, 3, 1, dtype=jnp.float64)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    x, v = rng.normal(size=(6, 2)), rng.normal(size=(6, 2))
    for tangent in (None, v):
        want = jbase.jax_jet_derivatives(jp, jnp.asarray(x), order,
                                         None if tangent is None else jnp.asarray(tangent))
        got = tbase.taylor_jet_derivatives(
            tp, torch.from_numpy(x), order,
            None if tangent is None else torch.from_numpy(tangent))
        _close(got, want)


def test_grid_and_cross_agree_with_the_ntp_engine():
    """The oracle inherits grid/cross from the base class: the same tables
    as eager ntp, which the port's parity tests hold to the reference."""
    net = make_network("dense", d_in=2, d_out=1, width=8, depth=3)
    p = net.init(torch.Generator().manual_seed(0), torch.float64, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, size=(4, 2)))
    _close(JetEngine().grid(net, p, x, 4), NTPEngine().grid(net, p, x, 4), keep=2)
    for axes in ((0, 1), (0, 0, 1, 1)):
        _close(JetEngine().cross(net, p, x, axes), NTPEngine().cross(net, p, x, axes),
               keep=0)


def test_spec_round_trip_and_aliases():
    for spelling in ("jet", "jax-jet", "jaxjet", "JET", " Jax-Jet "):
        spec = EngineSpec.parse(spelling)
        assert spec == EngineSpec("jet") and str(spec) == "jet"
        assert isinstance(spec.build(), JetEngine)
        assert isinstance(DerivativeEngine.from_spec(spelling), JetEngine)
    eng = JetEngine()
    assert eng.spec == "jet" and EngineSpec.parse(eng) == EngineSpec("jet")
    assert DerivativeEngine.from_spec(eng) is eng
    for spec in ("ntp", "ntp/cuda", "autodiff", "jet"):
        assert str(EngineSpec.parse(str(EngineSpec.parse(spec)))) == spec
    for bad in ("jet/torch", "jet/cuda", "jax-jet/x", "jets"):
        with pytest.raises(ValueError, match="engine spec"):
            EngineSpec.parse(bad)


# ---------------------------------------------------------------------------
# rule-level checks against jax.experimental.jet pushforwards (the checks
# tests/test_engines.py runs on the jet algebra)
# ---------------------------------------------------------------------------

def _rand(seed, order, shape=(3,), positive=False):
    c = 0.5 * np.random.default_rng(seed).normal(size=(order + 1,) + shape)
    if positive:
        c[0] = np.abs(c[0]) + 1.0
    return c


def _check(fn_torch, fn_jax, *coeffs):
    """Raw derivatives of fn(*series) by the Taylor rules against
    jax.experimental.jet on the same series."""
    got = T.raw_derivatives(fn_torch(*(T.Taylor(torch.from_numpy(c)) for c in coeffs)))
    facts = [np.array([float(np.prod(np.arange(1, k + 1))) for k in range(c.shape[0])])
             .reshape((-1,) + (1,) * (c.ndim - 1)) for c in coeffs]
    raws = [c * f for c, f in zip(coeffs, facts)]
    y0, ys = jjet.jet(fn_jax, tuple(jnp.asarray(r[0]) for r in raws),
                      tuple([jnp.asarray(t) for t in r[1:]] for r in raws))
    np.testing.assert_allclose(got.numpy(), np.stack([y0] + list(ys)), **RULE_TOL)


ORDER_SEEDS = [(o, s) for o in (1, 3, 6) for s in (0, 7)]


@pytest.mark.parametrize("order,seed", ORDER_SEEDS)
def test_unary_rules_match_jax_jet(order, seed):
    a = _rand(seed, order)
    pos = _rand(seed + 1, order, positive=True)
    _check(torch.exp, jnp.exp, a)
    _check(torch.tanh, jnp.tanh, a)
    _check(torch.sigmoid, jax.nn.sigmoid, a)
    _check(torch.sin, jnp.sin, a)
    _check(torch.cos, jnp.cos, a)
    # jax.experimental.jet has no rule for logaddexp's custom_jvp: its
    # side is the same function through exp and log
    _check(lambda t: torch.logaddexp(t, torch.zeros_like(t)),
           lambda t: jnp.log(1.0 + jnp.exp(t)), a)
    _check(lambda t: torch.clamp(t, min=0.0), lambda t: jnp.maximum(t, 0.0), a)
    _check(lambda t: t ** 3, lambda t: t ** 3, a)
    _check(torch.log, jnp.log, pos)
    _check(lambda t: t ** 1.7, lambda t: jnp.power(t, 1.7), pos)
    _check(torch.sqrt, jnp.sqrt, pos)
    _check(torch.rsqrt, jax.lax.rsqrt, pos)


@pytest.mark.parametrize("order,seed", ORDER_SEEDS)
def test_arithmetic_rules_match_jax_jet(order, seed):
    a, b = _rand(seed, order), _rand(seed + 1, order)
    pos = _rand(seed + 2, order, positive=True)
    const = np.random.default_rng(seed + 3).normal(size=(3,))
    _check(lambda x, y: x * y, lambda x, y: x * y, a, b)
    _check(lambda x, y: x / y, jnp.divide, a, pos)
    _check(lambda x: 2.0 / x, lambda x: 2.0 / x, pos)
    _check(lambda x, y: x - y + 1.5, lambda x, y: x - y + 1.5, a, b)
    _check(lambda x: 1.0 - 0.5 * x, lambda x: 1.0 - 0.5 * x, a)
    _check(lambda x: torch.from_numpy(const) - x, lambda x: const - x, a)
    _check(lambda x, y: torch.logaddexp(x, y),
           lambda x, y: jnp.log(jnp.exp(x) + jnp.exp(y)), a, b)


@pytest.mark.parametrize("order,seed", ORDER_SEEDS)
def test_softmax_and_rms_norm_rules_match_jax_jet(order, seed):
    a = _rand(seed, order, shape=(2, 4))
    _check(lambda t: torch.softmax(t, dim=-1), jax.nn.softmax, a)
    gamma = np.linspace(0.5, 1.5, 4)

    def rms(mod, lib):
        def f(x):
            ms = (x * x).mean(-1, keepdims=True) if lib is jnp else \
                (x * x).mean(dim=-1, keepdim=True)
            inv = jax.lax.rsqrt(ms + 1e-6) if lib is jnp else torch.rsqrt(ms + 1e-6)
            return x * inv * mod(gamma)
        return f

    _check(rms(torch.from_numpy, torch), rms(jnp.asarray, jnp), a)


@pytest.mark.parametrize("order,seed", ORDER_SEEDS)
def test_einsum_matmul_rules_match_jax_jet(order, seed):
    a, b = _rand(seed, order, shape=(2, 3, 4)), _rand(seed + 1, order, shape=(2, 3, 4))
    eq = "bqd,bkd->bqk"
    _check(lambda x, y: torch.einsum(eq, x, y), lambda x, y: jnp.einsum(eq, x, y), a, b)
    ah, bh = _rand(seed + 2, order, shape=(2, 3, 2, 2)), _rand(seed + 3, order, shape=(2, 3, 2, 2))
    eqh = "...qhd,...khd->...hqk"
    _check(lambda x, y: torch.einsum(eqh, x, y), lambda x, y: jnp.einsum(eqh, x, y), ah, bh)
    const = np.random.default_rng(seed + 4).normal(size=(2, 3, 4))
    _check(lambda x: torch.einsum(eq, x, torch.from_numpy(const)),
           lambda x: jnp.einsum(eq, x, const), a)
    w = np.random.default_rng(seed + 5).normal(size=(4, 5))
    _check(lambda x: x @ torch.from_numpy(w), lambda x: x @ w, a)
    _check(lambda x, y: x @ y, lambda x, y: x @ y, a, _rand(seed + 6, order, shape=(2, 4, 3)))


@pytest.mark.parametrize("order,seed", ORDER_SEEDS)
def test_structural_rules_match_jax_jet(order, seed):
    a, b = _rand(seed, order, shape=(3, 4)), _rand(seed + 1, order, shape=(3, 4))
    mask = np.random.default_rng(seed).random((3, 4)) < 0.5
    tm = torch.from_numpy(mask)
    _check(lambda x, y: torch.where(tm, x, y), lambda x, y: jnp.where(mask, x, y), a, b)
    row = np.random.default_rng(seed + 2).random(4) < 0.5
    _check(lambda x, y: torch.where(torch.from_numpy(row), x, y),
           lambda x, y: jnp.where(row, x, y), a, b)
    _check(lambda x: torch.where(tm, x, torch.full_like(x, -30.0)),
           lambda x: jnp.where(mask, x, -30.0), a)
    _check(lambda x, y: torch.cat([x, y], dim=-1), lambda x, y: jnp.concatenate([x, y], -1),
           a, b)
    _check(lambda x: x.reshape(4, 3)[..., :, None].sum(0).mean(dim=-1),
           lambda x: x.reshape(4, 3)[..., :, None].sum(0).mean(-1), a)


def test_an_op_without_a_rule_raises_and_names_it():
    t = T.seed(torch.zeros((2, 3), dtype=torch.float64), None, 3)
    for call, name in ((torch.erf, "erf"), (torch.atan, "atan"),
                       (lambda x: x.detach(), "detach"), (lambda x: x.abs(), "abs"),
                       (lambda x: x.erfinv(), "erfinv")):
        with pytest.raises(NotImplementedError, match=name):
            call(t)


def test_a_constant_output_has_zero_derivatives():
    x = torch.ones((3, 2), dtype=torch.float64)
    out = T.taylor_derivatives(lambda t: torch.ones((3, 1), dtype=torch.float64), x, 4)
    assert out.shape == (5, 3, 1)
    assert bool((out[0] == 1).all()) and bool((out[1:] == 0).all())
