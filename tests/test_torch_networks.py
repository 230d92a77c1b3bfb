"""The port's residual and Fourier-feature networks (``ResidualMLP``,
``FourierFeatureMLP`` and their ``FourierFeatures`` embedding) against the
JAX package: primal forward, ``grid`` and ``cross`` tables under both
port impls against the reference's ``NTPEngine("jnp")``, the parameter
trees and their checkpoints through ``repro_torch.bridge``, what reaches
the dense kernel under ``impl="cuda"``, the embedding's frozen ``B``, and
``train_operator`` with ``network="residual" | "fourier"`` step for step.

Parameters come from the reference's ``init``; inputs are drawn with
numpy.  Float64; tables 1e-12 relative to each table slice's max |ref|;
training 1e-6 relative on every logged loss (tests/test_torch_train.py
gives the reason).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt.manager import CheckpointManager
from repro.core.engines import NTPEngine as JNTP
from repro.core.network import make_network as jmake
from repro.data import collocation as jcol
from repro.pinn import trainer as jtrainer
from repro.pinn.operators import get_operator as jget_operator
from repro_torch import bridge
from repro_torch.core import modules as tmod
from repro_torch.core.engines import NTPEngine
from repro_torch.core.network import (FourierFeatureMLP, ResidualMLP, make_network,
                                      network_names)
from repro_torch.kernels import ops as tops
from repro_torch.pinn import trainer as ttrainer
from repro_torch.pinn.trainer import value_and_grad

TOL = 1e-12
TOL_TRAIN = 1e-6
NETS = {"residual": {}, "fourier": {"n_features": 4, "feature_scale": 0.8}}
KW = dict(d_in=2, d_out=1, width=8, depth=2)


def _port(jtree):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                                    device="cpu")


def _close(got, want, keep, tol=TOL):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    lead = want.shape[:keep]
    d = np.abs(got - want).reshape(lead + (-1,)).max(-1)
    s = np.maximum(np.abs(want).reshape(lead + (-1,)).max(-1), 1e-300)
    assert np.all(d <= tol * s), float((d / s).max())


@pytest.fixture(scope="module")
def nets():
    out = {}
    for kind, extra in NETS.items():
        jnet = jmake(kind, **KW, **extra)
        jp = jnet.init(jax.random.PRNGKey(7), dtype=jnp.float64)
        out[kind] = (jnet, jp, make_network(kind, **KW, **extra), _port(jp))
    x = np.random.default_rng(3).uniform(-1, 1, size=(6, 2))
    return out, x


def test_registered_with_the_reference_trees(nets):
    assert {"residual", "fourier"} <= set(network_names())
    assert isinstance(make_network("residual", **KW), ResidualMLP)
    assert isinstance(make_network("fourier", **KW), FourierFeatureMLP)
    assert make_network("fourier", **KW).n_features == 16          # reference default
    out, _ = nets
    for kind, (jnet, jp, tnet, tp) in out.items():
        own = tnet.init(torch.Generator().manual_seed(0), torch.float64, device="cpu")
        assert sorted(bridge.leaf_keys(own)) == sorted(bridge.leaf_keys(tp))
        for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(
                bridge.params_to_numpy(own))):
            assert np.shape(a) == np.shape(b)
    assert set(out["residual"][3]) == {"w_in", "b_in", "blocks", "w_out", "b_out"}
    assert set(out["fourier"][3]) == {"B", "mlp"}


@pytest.mark.parametrize("kind", NETS)
def test_apply_matches_reference(nets, kind):
    out, x = nets
    jnet, jp, tnet, tp = out[kind]
    _close(tnet.apply(tp, torch.tensor(x)), jnet.apply(jp, jnp.asarray(x)), 0)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("kind", NETS)
@pytest.mark.parametrize("what,arg", [("grid", 4), ("cross", (0, 0, 1, 1)),
                                      ("cross", (0, 1))])
def test_tables_match_reference(nets, kind, impl, what, arg):
    out, x = nets
    jnet, jp, tnet, tp = out[kind]
    jfn, tfn = ((JNTP("jnp").grid, NTPEngine(impl).grid) if what == "grid"
                else (JNTP("jnp").cross, NTPEngine(impl).cross))
    want = jax.jit(lambda p, xx: jfn(jnet, p, xx, arg))(jp, jnp.asarray(x))
    _close(tfn(tnet, tp, torch.tensor(x), arg), want, 2 if what == "grid" else 0)


def test_dense_layers_reach_the_fused_kernel(nets, monkeypatch):
    """Under impl="cuda" every Dense is one ops.jet_dense call with its
    activation fused; the residual adds and the sin/cos embedding stay jet
    algebra (no act_jet)."""
    calls = []
    real = tops.jet_dense
    monkeypatch.setattr(tops, "jet_dense", lambda c, w, b, act: (
        calls.append((tuple(w.shape), act)), real(c, w, b, act))[1])
    monkeypatch.setattr(tops, "act_jet", lambda *a: pytest.fail("act_jet reached"))
    out, x = nets
    for kind, want in (("residual", [((2, 8), "tanh"), ((8, 8), "tanh"),
                                     ((8, 8), "tanh"), ((8, 1), None)]),
                       ("fourier", [((8, 8), "tanh"), ((8, 8), "tanh"), ((8, 1), None)])):
        calls.clear()
        _, _, tnet, tp = out[kind]
        NTPEngine("cuda").grid(tnet, tp, torch.tensor(x), 3)
        assert calls == want, kind


def test_fourier_features_are_frozen_and_match_reference():
    """B is excluded from gradients (detach, the reference's
    stop_gradient); the module's primal and jet match the reference's."""
    from repro.core import jet as JJ
    from repro.core import modules as jmod
    from repro_torch.core import jet as TJ
    jm, tm = jmod.FourierFeatures(2, 4, 0.7), tmod.FourierFeatures(2, 4, 0.7)
    jb = jm.init(jax.random.PRNGKey(1), dtype=jnp.float64)
    b = torch.tensor(np.asarray(jb), requires_grad=True)
    c = np.random.default_rng(2).normal(size=(4, 3, 2)) * 0.5
    out = tm.jet_apply(b, TJ.Jet(torch.tensor(c)))
    _close(out.coeffs, jm.jet_apply(jb, JJ.Jet(jnp.asarray(c))).coeffs, 1)
    _close(tm.apply(b, torch.tensor(c[0])), jm.apply(jb, jnp.asarray(c[0])), 0)
    assert out.coeffs.requires_grad is False
    (_, _), grads = value_and_grad(
        lambda p, xx: (tm.apply(p, xx).sum() + (p * 0).sum(), {}), b, torch.tensor(c[0]))
    jgrad = jax.grad(lambda p: jm.apply(p, jnp.asarray(c[0])).sum())(jb)
    assert not np.any(np.asarray(jgrad)) and not torch.any(grads)
    assert tm.init(torch.Generator().manual_seed(0), torch.float64, "cpu").shape == (2, 4)


@pytest.mark.parametrize("kind", NETS)
def test_checkpoint_and_bridge_roundtrip(nets, kind, tmp_path):
    out, _ = nets
    jnet, jp, tnet, tp = out[kind]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, jp)
    loaded = bridge.load_jax_checkpoint(str(tmp_path), tnet, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(bridge.params_to_numpy(loaded))):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = bridge.params_from_numpy(bridge.params_to_numpy(tp), device="cpu")
    assert bridge.leaf_keys(back) == bridge.leaf_keys(tp)
    with pytest.raises(ValueError, match="missing"):
        bridge.load_jax_checkpoint(str(tmp_path), make_network(
            kind, **dict(KW, depth=3), **NETS[kind]), device="cpu")


@pytest.mark.parametrize("network", ["residual", "fourier"])
def test_train_operator_matches_reference_step_for_step(network):
    """OperatorRunConfig(network=...) builds the network through
    make_network and trains it with nothing else changed: ntp/cuda (plain
    versions here) step for step with the reference's ntp, its draws
    replayed."""
    kw = dict(op="heat", network=network, width=8, depth=2, n_domain=24, n_bc=4,
              adam_steps=3, lbfgs_steps=2, resample_every=2, log_every=1,
              eval_pts_per_axis=6)
    if network == "fourier":
        kw["net_kwargs"] = {"n_features": 4}
    want = jtrainer.train_operator(jtrainer.OperatorRunConfig(**kw, engine="ntp"))
    cfg = ttrainer.OperatorRunConfig(**kw, engine="ntp/cuda")
    op = jget_operator(cfg.op)
    k_init, k_pts = jax.random.split(jax.random.PRNGKey(cfg.seed))
    draws = {0: jcol.sample_box(k_pts, op.domain, cfg.n_domain, jnp.float64)}
    k_pts, sub = jax.random.split(k_pts)
    draws[2] = jcol.sample_box(sub, op.domain, cfg.n_domain, jnp.float64)
    lbfgs_pts = jcol.sample_box(jax.random.PRNGKey(cfg.seed + 1), op.domain,
                                cfg.n_domain, jnp.float64)
    got = ttrainer.train_operator(
        cfg, device="cpu", init_params=_port(want.net.init(k_init, dtype=jnp.float64)),
        sampler=lambda step: torch.tensor(np.asarray(draws[step])),
        lbfgs_pts=torch.tensor(np.asarray(lbfgs_pts)))
    assert type(got.net).__name__ == type(want.net).__name__
    assert len(got.loss_history) == len(want.loss_history)
    for a, b in zip(got.loss_history, want.loss_history):
        assert math.isfinite(a) and abs(a - b) <= TOL_TRAIN * abs(b)
    assert abs(got.l2_error - want.l2_error) <= TOL_TRAIN * want.l2_error
    assert got.n_params == want.n_params
