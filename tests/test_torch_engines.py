"""The port's derivative engines against the JAX package's, on the same
parameters (made by the JAX init, carried over through repro_torch.bridge).

NTP ``grid`` (orders 0-4) and ``cross`` for DenseMLP and MLP under the
port's impls ``"torch"`` (against the reference's ``"jnp"``) and ``"cuda"``
(plain versions on CPU, against the reference's ``"pallas"``, interpret
mode); the nested-autodiff engines against each other at orders <= 4; and
the MLPParams wrappers of core/ntp.py.  Float64 throughout; tolerance 1e-12
relative to each table slice's max |ref|.  JAX tables are cached per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ntp as jntp
from repro.core.engines import AutodiffEngine as JAutodiff
from repro.core.engines import NTPEngine as JNTP
from repro.core.network import make_network as jmake
from repro_torch import bridge
from repro_torch.core import ntp as tntp
from repro_torch.core.engines import (AutodiffEngine, DerivativeEngine,
                                      EngineSpec, NTPEngine)
from repro_torch.core.network import DenseMLP, make_network, network_names
from repro_torch.tree import bit_equal

TOL = 1e-12
NETS = {"dense": dict(d_in=2, d_out=1, width=8, depth=2),
        "mlp": dict(d_in=2, d_out=1, width=6, depth=2)}
IMPLS = {"torch": "jnp", "cuda": "pallas"}
CROSS_AXES = ((0, 1), (0, 0, 1), (0, 0, 1, 1))
GRID_ORDER = 4    # highest grid order the tests ask of the JAX engines


def _close(got, want, keep):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    lead = want.shape[:keep]
    d = np.abs(got - want).reshape(lead + (-1,)).max(-1)
    s = np.maximum(np.abs(want).reshape(lead + (-1,)).max(-1), 1e-300)
    assert np.all(d <= TOL * s), float((d / s).max())


@pytest.fixture(scope="module")
def setup():
    out = {}
    for kind, kw in NETS.items():
        jnet = jmake(kind, **kw)
        jp = jnet.init(jax.random.PRNGKey(3), dtype=jnp.float64)
        tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")
        out[kind] = (jnet, jp, make_network(kind, **kw), tp)
    x = np.random.default_rng(0).uniform(-1, 1, size=(6, 2))
    return out, x, {}


def _jax_table(setup, kind, impl, what, arg):
    """The JAX engine's table, jitted (one compile is cheaper than eager
    dispatch here).  A grid of order k is the first k+1 orders of the
    order-4 grid, so one JAX call per (kind, impl) serves every order."""
    nets, x, cache = setup
    key = (kind, impl, what, None if what == "grid" else arg)
    if key not in cache:
        jnet, jp, _, _ = nets[kind]
        eng = JNTP(impl) if impl in ("jnp", "pallas") else JAutodiff()
        fn = eng.grid if what == "grid" else eng.cross
        full = GRID_ORDER if what == "grid" else arg
        cache[key] = np.asarray(
            jax.jit(lambda p, xx: fn(jnet, p, xx, full))(jp, jnp.asarray(x)))
    return cache[key][:, :arg + 1] if what == "grid" else cache[key]


@pytest.mark.parametrize("order", range(5))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", NETS)
def test_ntp_grid_matches_reference(setup, kind, impl, order):
    nets, x, _ = setup
    _, _, tnet, tp = nets[kind]
    got = NTPEngine(impl).grid(tnet, tp, torch.tensor(x), order)
    assert got.shape == (2, order + 1, 6, 1)
    _close(got, _jax_table(setup, kind, IMPLS[impl], "grid", order), keep=2)


@pytest.mark.parametrize("axes", CROSS_AXES)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", NETS)
def test_ntp_cross_matches_reference(setup, kind, impl, axes):
    nets, x, _ = setup
    _, _, tnet, tp = nets[kind]
    got = NTPEngine(impl).cross(tnet, tp, torch.tensor(x), axes)
    _close(got, _jax_table(setup, kind, IMPLS[impl], "cross", axes), keep=0)


@pytest.mark.parametrize("order", (1, 2, 4))
@pytest.mark.parametrize("kind", NETS)
def test_autodiff_engine_matches_reference(setup, kind, order):
    nets, x, _ = setup
    _, _, tnet, tp = nets[kind]
    got = AutodiffEngine().grid(tnet, tp, torch.tensor(x), order)
    _close(got, _jax_table(setup, kind, "autodiff", "grid", order), keep=2)


def test_autodiff_vector_output_uses_jacfwd_and_matches_ntp():
    net = DenseMLP(d_in=2, width=5, depth=2, d_out=2)
    p = net.init(torch.Generator().manual_seed(1), torch.float64, device="cpu")
    x = torch.rand((4, 2), dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    a = AutodiffEngine().grid(net, p, x, 3)
    b = NTPEngine("torch").grid(net, p, x, 3)
    assert a.shape == b.shape == (2, 4, 4, 2)
    _close(a, b.numpy(), keep=2)


@pytest.mark.parametrize("act", ("tanh", "softplus"))
@pytest.mark.parametrize("impl", IMPLS)
def test_ntp_module_wrappers_match_reference(setup, impl, act):
    """ntp_derivatives / ntp_grid / cross of core/ntp.py over MLPParams.
    softplus has no kernel epilogue, so under "cuda" it composes through
    the jet algebra after the dense kernel.  The reference's own Pallas
    branch of these wrappers raises for softplus (its ref.jet_dense_ref
    has tanh/sigmoid/sin only), so softplus is held against its jet
    algebra ("jnp")."""
    nets, x, _ = setup
    _, jp, _, tp = nets["dense"]
    jimpl = IMPLS[impl] if act == "tanh" else "jnp"
    xt, xj = torch.tensor(x), jnp.asarray(x)
    v = np.random.default_rng(4).normal(size=x.shape)
    kw, jkw = dict(activation=act, impl=impl), dict(activation=act, impl=jimpl)

    def jref(fn, *args):
        return jax.jit(lambda p, x, *rest: fn(p, x, *rest, **jkw))(jp, xj, *args)
    _close(tntp.ntp_derivatives(tp, xt, 3, torch.tensor(v), **kw),
           jref(lambda p, x, vv, **k: jntp.ntp_derivatives(p, x, 3, vv, **k),
                jnp.asarray(v)), keep=1)
    _close(tntp.ntp_derivatives(tp, xt, 0, **kw),
           jref(lambda p, x, **k: jntp.ntp_derivatives(p, x, 0, **k)), keep=1)
    _close(tntp.ntp_grid(tp, xt, 2, **kw),
           jref(lambda p, x, **k: jntp.ntp_grid(p, x, 2, **k)), keep=2)
    _close(tntp.cross(tp, xt, (0, 1), **kw),
           jref(lambda p, x, **k: jntp.cross(p, x, (0, 1), **k)), keep=0)


def test_mlp_apply_and_init_shapes():
    g = torch.Generator().manual_seed(0)
    p = tntp.init_mlp(g, 2, 32, 3, 1, dtype=torch.float64, device="cpu")
    assert p.w_in.shape == (2, 32) and p.w_hidden.shape == (2, 32, 32)
    assert p.b_hidden.shape == (2, 32) and p.w_out.shape == (32, 1)
    lim = (6.0 / (32 + 32)) ** 0.5
    assert float(p.w_hidden.abs().max()) <= lim
    again = tntp.init_mlp(torch.Generator().manual_seed(0), 2, 32, 3, 1,
                          dtype=torch.float64, device="cpu")
    assert bit_equal(p, again)
    net = DenseMLP.from_params(p)
    assert (net.d_in, net.width, net.depth, net.d_out) == (2, 32, 3, 1)
    x = torch.rand((3, 2), dtype=torch.float64)
    np.testing.assert_allclose(net.apply(p, x).numpy(),
                               net._graph().apply(net._graph_params(p), x).numpy(),
                               rtol=1e-14)


def test_engine_spec_canonical_forms():
    assert str(EngineSpec.parse("ntp")) == str(EngineSpec.parse("ntp/torch")) == "ntp"
    assert EngineSpec.parse("ntp") == EngineSpec.parse("NTP/torch")
    assert str(EngineSpec.parse("ntp/cuda")) == "ntp/cuda"
    assert str(EngineSpec.parse("autodiff")) == "autodiff"
    assert str(EngineSpec.parse("jax-jet")) == str(EngineSpec.parse("jaxjet")) == "jet"
    for s in ("ntp", "ntp/cuda", "autodiff", "jet"):
        spec = EngineSpec.parse(s)
        assert EngineSpec.parse(str(spec)) == spec
        assert str(EngineSpec.parse(DerivativeEngine.from_spec(s))) == s
    assert isinstance(DerivativeEngine.from_spec("ntp/cuda"), NTPEngine)
    eng = NTPEngine("cuda")
    assert DerivativeEngine.from_spec(eng) is eng
    for bad in ("ntp/pallas", "jet/torch", "autodiff/cuda", "nope"):
        with pytest.raises(ValueError):
            EngineSpec.parse(bad)
    with pytest.raises(ValueError):
        NTPEngine("jnp")


def test_cross_validates_axes(setup):
    nets, x, _ = setup
    _, _, tnet, tp = nets["dense"]
    with pytest.raises(ValueError):
        NTPEngine().cross(tnet, tp, torch.tensor(x), ())
    with pytest.raises(ValueError):
        NTPEngine().cross(tnet, tp, torch.tensor(x), (0, 2))


def test_network_registry():
    """The port registers every network the reference does."""
    from repro.core.network import network_names as jnetwork_names
    assert network_names() == jnetwork_names() == (
        "dense", "fourier", "mlp", "residual", "transformer")
    with pytest.raises(KeyError):
        make_network("siren", d_in=2, d_out=1, width=4, depth=1)
