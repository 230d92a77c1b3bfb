"""The port's PINN layer against the JAX package: collocation, the
``DerivTable``, the nine registered operators (residuals, exact values and
the manufactured-solution identity), the Burgers residual jets, the
baselines, ``pinn_loss`` and ``burgers_pinn_loss`` values and gradients,
and the two configuration records.

Parameters are made by the reference's ``init`` and carried over through
``repro_torch.bridge``; points are made with numpy.  The port runs on the
CPU: ``ntp/cuda`` there runs the kernels' plain versions.  Tolerance:
float64 1e-12 relative to the reference's max |value| (per slice for
tables), 3e-11 on the Transformer trunk (see TOL_TRUNK).  Widths are
small (8, depth 2): the JAX side is the expensive one here.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import baselines as jbase
from repro.core.network import make_network as jmake_network
from repro.core.ntp import init_mlp as jinit_mlp
from repro.data import collocation as jcol
from repro.pinn import burgers as jburg
from repro.pinn import losses as jloss
from repro.pinn import operators as jops
from repro_torch import bridge, tree
from repro_torch.configs import get_arch
from repro_torch.core import baselines as tbase
from repro_torch.core import jet as TJ
from repro_torch.core.network import make_network
from repro_torch.data import collocation as tcol
from repro_torch.pinn import burgers as tburg
from repro_torch.pinn import losses as tloss
from repro_torch.pinn import operators as tops
from repro_torch.pinn.trainer import value_and_grad

TOL = 1e-12
# the trunk's tables carry cancellation at its zero-bias init (see
# tests/test_torch_attention.py, TOL_TRUNK)
TOL_TRUNK = 3e-11
OPS = ("heat", "wave", "kdv", "allen-cahn", "poisson2d", "advection-diffusion",
       "burgers", "navier-stokes", "gray-scott")


_REFERENCE = {}


def _once(key, fn):
    """A reference result shared by the port engines held against it."""
    if key not in _REFERENCE:
        _REFERENCE[key] = fn()
    return _REFERENCE[key]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL, keep=0):
    """max |got - want| <= tol * max |want| over each slice of the leading
    ``keep`` axes."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    lead = want.shape[:keep]
    d = np.abs(got - want).reshape(lead + (-1,)).max(-1)
    s = np.maximum(np.abs(want).reshape(lead + (-1,)).max(-1), 1e-300)
    assert np.all(d <= tol * s), float((d / s).max())


def _port(jparams):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                    device="cpu")


def _points(seed, op, n):
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in op.domain])
    hi = np.array([b[1] for b in op.domain])
    return lo + (hi - lo) * rng.uniform(size=(n, op.d_in))


def _grads_close(got_tree, want_tree, tol):
    got, want = tree.leaves(got_tree), jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        assert np.abs(_np(g) - np.asarray(w)).max() <= tol * scale


# ---------------------------------------------------------------------------
# data/collocation.py
# ---------------------------------------------------------------------------

DOMAINS = [((-2.0, 2.0),), ((0.0, 1.0), (-math.pi, math.pi)),
           ((0.0, 1.0), (-1.0, 1.0), (-2.0, 2.0))]


@pytest.mark.parametrize("domain", DOMAINS, ids=lambda d: f"d{len(d)}")
def test_deterministic_grids_match_reference(domain):
    _close(tcol.boundary_grid(domain, 16, device="cpu"),
           jcol.boundary_grid(domain, 16), 1e-15)
    _close(tcol.eval_grid(domain, 7, device="cpu"), jcol.eval_grid(domain, 7), 1e-15)
    _close(tcol.uniform_grid(-1.5, 2.0, 33, device="cpu"),
           jcol.uniform_grid(-1.5, 2.0, 33), 1e-15)


def test_random_samplers_are_seeded_boxes():
    domain = DOMAINS[2]
    a = tcol.sample_box(torch.Generator().manual_seed(3), domain, 500, device="cpu")
    b = tcol.sample_box(torch.Generator().manual_seed(3), domain, 500, device="cpu")
    assert a.shape == (500, 3) and a.dtype == torch.float64
    assert tree.bit_equal(a, b)
    for axis, (lo, hi) in enumerate(domain):
        assert lo <= float(a[:, axis].min()) and float(a[:, axis].max()) <= hi
        assert float(a[:, axis].max() - a[:, axis].min()) > 0.9 * (hi - lo)
    pts, org = tcol.resample(torch.Generator().manual_seed(0), -2.0, 2.0, 64, 16,
                             0.15, device="cpu")
    assert pts.shape == (64, 1) and org.shape == (16, 1)
    assert float(pts.abs().max()) <= 2.0 and float(org.abs().max()) <= 0.15
    jp, jo = jcol.resample(jax.random.PRNGKey(0), -2.0, 2.0, 64, 16, 0.15)
    assert jp.shape == tuple(pts.shape) and jo.shape == tuple(org.shape)


# ---------------------------------------------------------------------------
# pinn/operators.py: the table, the registry and the nine operators
# ---------------------------------------------------------------------------

def test_deriv_table_indexes_like_the_reference():
    rng = np.random.default_rng(1)
    pure, mixed = rng.normal(size=(2, 3, 5, 2)), rng.normal(size=(5, 2))
    jt = jops.DerivTable(jnp.asarray(pure), {(0, 1): jnp.asarray(mixed)})
    tt = tops.DerivTable(torch.tensor(pure), {(0, 1): torch.tensor(mixed)})
    assert tt.n_components == jt.n_components == 2
    for axis, k, comp in [(0, 0, 0), (1, 2, 1), (0, 1, 1)]:
        np.testing.assert_array_equal(_np(tt(axis, k, comp=comp)),
                                      np.asarray(jt(axis, k, comp=comp)))
    np.testing.assert_array_equal(_np(tt.mixed(1, 0, comp=1)),
                                  np.asarray(jt.mixed(1, 0, comp=1)))
    with pytest.raises(IndexError, match="comp=2"):
        tt(0, 0, comp=2)
    with pytest.raises(IndexError, match="comp=-1"):
        tt.mixed(0, 1, comp=-1)
    with pytest.raises(IndexError, match="out of range"):
        tt(2, 0)
    with pytest.raises(KeyError, match="not precomputed"):
        tt.mixed(0, 0)
    scalar = tops.DerivTable(torch.tensor(pure[..., 0]), {(0,): torch.tensor(mixed[:, 0])})
    assert scalar.n_components == 1 and scalar.mixed(0).shape == (5,)


def test_registry_holds_the_nine_operators():
    assert tops.operator_names() == jops.operator_names() == tuple(sorted(OPS))
    for name in OPS:
        t, j = tops.get_operator(name), jops.get_operator(name)
        assert (t.d_in, t.d_out, t.order, t.mixed, t.domain,
                t.differentiable_exact) == \
            (j.d_in, j.d_out, j.order, j.mixed, j.domain, j.differentiable_exact)
    with pytest.raises(KeyError, match="unknown operator"):
        tops.get_operator("nope")
    with pytest.raises(ValueError, match="already registered"):
        tops.register(tops.get_operator("heat"))
    bad = tops.Operator(name="bad", d_in=2, order=1, residual=None, exact=None,
                        domain=((0.0, 1.0),))
    with pytest.raises(ValueError, match="domain rank"):
        tops.register(bad)


@pytest.fixture(scope="module")
def dense_nets():
    """Per operator: the reference's DenseMLP params (width 8, depth 2),
    carried over, and 6 interior points."""
    out = {}
    for i, name in enumerate(OPS):
        op = jops.get_operator(name)
        kw = dict(d_in=op.d_in, d_out=op.d_out, width=8, depth=2)
        jnet = jmake_network("dense", **kw)
        jp = jnet.init(jax.random.PRNGKey(10 + i), dtype=jnp.float64)
        out[name] = (jnet, jp, make_network("dense", **kw), _port(jp),
                     _points(20 + i, op, 6))
    return out


@pytest.mark.parametrize("impl", ["ntp", "ntp/cuda"])
@pytest.mark.parametrize("name", OPS)
def test_operator_residuals_match_reference(dense_nets, name, impl):
    jnet, jp, tnet, tp, x = dense_nets[name]
    want = _once(("residual", name), lambda: jax.jit(
        lambda p, xx: jops.residual_values(p, jops.get_operator(name), xx, net=jnet,
                                           engine="ntp"))(jp, jnp.asarray(x)))
    got = tops.residual_values(tp, tops.get_operator(name), torch.tensor(x),
                               net=tnet, engine=impl)
    _close(got, want, keep=1 if name == "gray-scott" else 0)


@pytest.mark.parametrize("name", OPS)
def test_exact_values_match_reference(name):
    op = jops.get_operator(name)
    x = _points(30, op, 9)
    want = jops.exact_values(op, jnp.asarray(x), jnp.float64)
    got = tops.exact_values(tops.get_operator(name), torch.tensor(x), torch.float64)
    assert tuple(got.shape) == (9, op.d_out)
    _close(got, want, 1e-14)


@pytest.mark.parametrize("name", [n for n in OPS if n != "burgers"])
def test_exact_solution_zeroes_the_residual(name):
    """Method of manufactured solutions on the port's own algebra: the
    residual of each exact solution, differentiated by nested autodiff
    towers, vanishes (to the towers' rounding)."""
    op = tops.get_operator(name)
    x = torch.tensor(_points(40, op, 5))
    r = tops.residual_of_fn(op, lambda xi: op.exact(xi[None])[0], x)
    assert float(r.abs().max()) < 1e-10


def test_ntp_pure_derivs_and_net_check():
    jp = jinit_mlp(jax.random.PRNGKey(2), 2, 8, 2, 1, dtype=jnp.float64)
    x = np.random.default_rng(3).uniform(-1, 1, size=(5, 2))
    want = jops.ntp_pure_derivs(jp, jnp.asarray(x), 3)
    for impl in ("torch", "cuda"):
        _close(tops.ntp_pure_derivs(_port(jp), torch.tensor(x), 3, impl=impl),
               want, keep=2)
    with pytest.raises(ValueError, match="d_out=1"):
        tops.check_net_matches(make_network("dense", d_in=2, d_out=1, width=4,
                                            depth=1), tops.get_operator("gray-scott"))


# ---------------------------------------------------------------------------
# pinn/burgers.py and core/baselines.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def burgers_net():
    jp = jinit_mlp(jax.random.PRNGKey(4), 1, 8, 2, 1, dtype=jnp.float64)
    x = np.random.default_rng(5).uniform(-0.3, 0.3, size=(7, 1))
    return jp, _port(jp), x


@pytest.mark.parametrize("order", [1, 3, 7])
def test_residual_jet_matches_reference_and_autodiff(burgers_net, order):
    jp, tp, x = burgers_net
    lam = 0.4
    want = jax.jit(lambda p, xx: jburg.residual_jet(p, lam, xx, order).coeffs)(
        jp, jnp.asarray(x))
    for impl in ("torch", "cuda"):
        got = tburg.residual_jet(tp, lam, torch.tensor(x), order, impl=impl)
        _close(got.coeffs, want, keep=1)
    ad = tburg.residual_derivs_autodiff(tp, lam, torch.tensor(x), order)
    ntp = TJ.derivatives(tburg.residual_jet(tp, lam, torch.tensor(x), order))
    _close(ad, ntp, 1e-10, keep=1)


def test_burgers_scalars_and_exact_profile():
    for k in (1, 2, 3):
        assert tburg.profile_lambda(k) == jburg.profile_lambda(k)
        assert tburg.lambda_window(k) == jburg.lambda_window(k)
        assert tburg.smoothness_order(k) == jburg.smoothness_order(k)
        assert tloss.bc_targets(k, 2.0) == jloss.bc_targets(k, 2.0)
    xs = np.linspace(-2, 2, 41)
    np.testing.assert_array_equal(tburg.exact_profile(xs, 2),
                                  jburg.exact_profile(xs, 2))


@pytest.mark.parametrize("fn", ["nested_autodiff", "nested_jacfwd"])
def test_baselines_match_reference(burgers_net, fn):
    jp, tp, x = burgers_net
    v = np.random.default_rng(6).normal(size=x.shape)
    want = jax.jit(lambda p, xx, vv: getattr(jbase, fn)(p, xx, 3, vv))(
        jp, jnp.asarray(x), jnp.asarray(v))
    got = getattr(tbase, fn)(tp, torch.tensor(x), 3, torch.tensor(v))
    _close(got, want, keep=1)


# ---------------------------------------------------------------------------
# pinn/losses.py: values and gradients
# ---------------------------------------------------------------------------

LOSS_CASES = [("heat", "dense"), ("gray-scott", "dense"),
              ("navier-stokes", "dense"), ("heat", "transformer")]


@pytest.mark.parametrize("engine", ["ntp", "ntp/cuda"])
@pytest.mark.parametrize("name,network", LOSS_CASES, ids=lambda v: str(v))
def test_pinn_loss_and_gradients_match_reference(name, network, engine):
    op = jops.get_operator(name)
    kw = dict(d_in=op.d_in, d_out=op.d_out, width=8, depth=2 if network == "dense" else 1)
    jnet = jmake_network(network, **kw)
    jp = jnet.init(jax.random.PRNGKey(7), dtype=jnp.float64)
    x = _points(8, op, 6)
    bc = np.asarray(jcol.boundary_grid(op.domain, 4))
    bv = np.asarray(jops.exact_values(op, jnp.asarray(bc), jnp.float64))

    def jl(p):
        return jloss.pinn_loss(p, op=op, pts=jnp.asarray(x), bc_pts=jnp.asarray(bc),
                               bc_vals=jnp.asarray(bv), net=jnet, engine="ntp")

    (want, jaux), jgrad = _once(("pinn_loss", name, network), lambda: jax.jit(
        jax.value_and_grad(jl, has_aux=True))(jp))
    tnet = make_network(network, **kw)
    top = tops.get_operator(name)

    def tl(p):
        return tloss.pinn_loss(p, op=top, pts=torch.tensor(x), bc_pts=torch.tensor(bc),
                               bc_vals=torch.tensor(bv), net=tnet, engine=engine)

    (got, aux), grads = value_and_grad(tl, _port(jp))
    tol = TOL_TRUNK if network == "transformer" else TOL
    _close(got, want, tol)
    _close(aux["residual"], jaux["residual"], tol)
    _close(aux["bc"], jaux["bc"], tol)
    _grads_close(grads, jgrad, tol)


def test_pinn_loss_mesh_raises_until_slice_d(tmp_path):
    """Slice D landed: ``mesh=`` takes a ``DataMesh`` (anything else still
    raises), and over 2 gloo ranks (``tests/_torch_ranks.py``) the sharded
    loss and its gradient equal the single-process ones at 1e-12."""
    import _torch_ranks
    net = make_network("dense", d_in=2, d_out=1, width=4, depth=1)
    x = torch.zeros((3, 2), dtype=torch.float64)
    p = net.init(torch.Generator().manual_seed(0), torch.float64, device="cpu")
    with pytest.raises(ValueError, match="'data' axis"):
        tloss.pinn_loss(p, op="heat", pts=x, bc_pts=x, bc_vals=x[:, 0], net=net,
                        mesh=object())
    for res in _torch_ranks.spawn(2, "pinn_loss_parity", tmp_path):
        np.testing.assert_allclose(*res["loss"], rtol=1e-12)
        assert res["grad_rel"] <= 1e-12, res["grad_rel"]


@pytest.mark.parametrize("engine", ["ntp", "ntp/cuda", "autodiff"])
def test_burgers_loss_and_gradients_match_reference(burgers_net, engine):
    jp, tp, _ = burgers_net
    rng = np.random.default_rng(9)
    pts, org = rng.uniform(-2, 2, size=(10, 1)), rng.uniform(-0.15, 0.15, size=(5, 1))
    k, order = 1, 3
    kw = dict(k=k, domain=2.0, order=order, weights=jloss.LossWeights(),
              lam_window=jburg.lambda_window(k), bc_vals=jloss.bc_targets(k, 2.0))

    def jl(ps):
        return jloss.burgers_pinn_loss(ps[0], ps[1], pts=jnp.asarray(pts),
                                       origin_pts=jnp.asarray(org), engine="ntp", **kw)

    lam_raw = 0.3
    (want, jaux), jgrad = _once("burgers_loss", lambda: jax.jit(
        jax.value_and_grad(jl, has_aux=True))((jp, jnp.asarray(lam_raw))))
    tkw = dict(kw, weights=tloss.LossWeights())

    def tl(ps):
        return tloss.burgers_pinn_loss(ps[0], ps[1], pts=torch.tensor(pts),
                                       origin_pts=torch.tensor(org), engine=engine,
                                       **tkw)

    (got, aux), grads = value_and_grad(
        tl, (tp, torch.tensor(lam_raw, dtype=torch.float64)))
    tol = 1e-10 if engine == "autodiff" else TOL
    _close(got, want, tol)
    for key in ("residual", "sobolev1", "origin", "bc", "lambda"):
        _close(aux[key], jaux[key], tol)
    _grads_close(grads, jgrad, tol)


@pytest.mark.parametrize("engine", ["ntp", "ntp/cuda"])
def test_burgers_k4_loss_and_gradients_match_reference(burgers_net, engine):
    """Profile k = 4: the u-jet of order 2k + 2 = 10, past the CUDA
    templates, through the port's kernel dispatch (plain versions here)."""
    jp, tp, _ = burgers_net
    rng = np.random.default_rng(11)
    pts, org = rng.uniform(-2, 2, size=(8, 1)), rng.uniform(-0.15, 0.15, size=(4, 1))
    k = 4
    order = jburg.smoothness_order(k)
    assert order + 1 == 10
    kw = dict(k=k, domain=2.0, order=order, lam_window=jburg.lambda_window(k),
              bc_vals=jloss.bc_targets(k, 2.0))

    def jl(ps):
        return jloss.burgers_pinn_loss(ps[0], ps[1], pts=jnp.asarray(pts),
                                       origin_pts=jnp.asarray(org), engine="ntp",
                                       weights=jloss.LossWeights(), **kw)

    (want, jaux), jgrad = _once("burgers_loss_k4", lambda: jax.jit(
        jax.value_and_grad(jl, has_aux=True))((jp, jnp.asarray(0.1))))

    def tl(ps):
        return tloss.burgers_pinn_loss(ps[0], ps[1], pts=torch.tensor(pts),
                                       origin_pts=torch.tensor(org), engine=engine,
                                       weights=tloss.LossWeights(), **kw)

    (got, aux), grads = value_and_grad(tl, (tp, torch.tensor(0.1, dtype=torch.float64)))
    _close(got, want)
    for key in ("residual", "sobolev1", "origin", "bc", "lambda"):
        _close(aux[key], jaux[key])
    _grads_close(grads, jgrad, TOL)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["pinn-mlp", "pinn-pde"])
def test_config_records_match_reference(name):
    from repro.configs import get_arch as jget_arch
    mine, theirs = get_arch(name), jget_arch(name)
    for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab", "attn_pattern", "dtype", "source"):
        assert getattr(mine, f) == getattr(theirs, f), f
