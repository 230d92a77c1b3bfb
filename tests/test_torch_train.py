"""The port's optimizers and trainers against the JAX package, step for
step: ``adam_update`` (which rounds through float32, as the reference's
does), ``lbfgs`` (strong-Wolfe line search on the ``ravel_pytree``
layout), and ``train`` / ``train_operator`` at width 8, depth 2, with the
reference's ``jax.random`` draws replayed through the trainers' injection
seam (``init_params``, ``sampler``, ``lbfgs_pts``).

Tolerances, each with its reason:
* Adam: 1e-6 relative.  The update runs in float32 in both packages; the
  port's float32 ops round as XLA's do except ``pow`` (the bias
  corrections), where the two libraries may differ by one float32 ulp
  (6e-8 relative).
* L-BFGS on a smooth test function: 1e-12 relative for every iterate.
  The search branches on float64 comparisons; at this tolerance a branch
  could flip only on a tie.
* Trainers: 1e-6 relative on every logged loss and on lambda.  Adam casts
  the float64 parameters through float32 at every step, so a one-ulp
  difference in a float32 rounding (the gradients agree to ~1e-13
  relative) moves a parameter by 6e-8 relative, and L-BFGS carries what
  Adam left.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.flatten_util import ravel_pytree

from repro.core.network import make_network as jmake_network
from repro.core.ntp import init_mlp as jinit_mlp
from repro.data import collocation as jcol
from repro.optim import adam_init as jadam_init
from repro.optim import adam_update as jadam_update
from repro.optim import lbfgs as jlbfgs
from repro.pinn import trainer as jtrainer
from repro.pinn.operators import get_operator as jget_operator
from repro_torch import bridge, tree
from repro_torch.optim import adam_init, adam_update, lbfgs
from repro_torch.pinn import trainer as ttrainer

TOL_ADAM = 1e-6
TOL_LBFGS = 1e-12
TOL_TRAIN = 1e-6
_REFERENCE_RUNS = {}


def _reference(run, cfg):
    """One reference training run per config, shared by the engines that
    are held against it (configs are dataclasses: their repr is a key)."""
    key = repr(cfg)
    if key not in _REFERENCE_RUNS:
        _REFERENCE_RUNS[key] = run(cfg)
    return _REFERENCE_RUNS[key]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _port(jtree):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                                    device="cpu")


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _trees_close(got_tree, want_tree, tol):
    got, want = tree.leaves(got_tree), jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) <= tol


# ---------------------------------------------------------------------------
# the flat layout
# ---------------------------------------------------------------------------

def test_ravel_matches_ravel_pytree_layout():
    """MLPParams, the (params, lam_raw) pair ``train`` optimizes and the
    Transformer's tree (dicts flatten by sorted key) ravel as the reference
    does, and unravel inverts ravel."""
    jp = jinit_mlp(jax.random.PRNGKey(0), 1, 4, 2, 1, dtype=jnp.float64)
    jt = jmake_network("transformer", d_in=2, d_out=1, width=4, depth=1,
                       n_heads=2).init(jax.random.PRNGKey(1), dtype=jnp.float64)
    for jtree in ((jp, jnp.asarray(0.25)), jt):
        want, _ = ravel_pytree(jtree)
        ptree = _port(jtree)
        flat, unravel = tree.ravel(ptree)
        np.testing.assert_array_equal(_np(flat), np.asarray(want))
        back = unravel(flat)
        for a, b in zip(tree.leaves(back), tree.leaves(ptree)):
            assert tree.bit_equal(a, b)
    assert tree.num_params(_port(jp)) == sum(x.size for x in
                                             jax.tree_util.tree_leaves(jp))


# ---------------------------------------------------------------------------
# optim/adam.py and optim/lbfgs.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay,grad_clip", [(0.0, None), (0.01, 0.5)])
def test_adam_matches_reference_step_for_step(weight_decay, grad_clip):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(3, 4)), "b": rng.normal(size=(4,)),
              "s": np.asarray(0.3)}
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _port(params)
    js, ts = jadam_init(jp), adam_init(tp)
    for step in range(5):
        g = {k: rng.normal(size=v.shape) * 10.0 ** (step - 2)
             for k, v in params.items()}
        kw = dict(weight_decay=weight_decay, grad_clip=grad_clip)
        jp, js = jadam_update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                              1e-2, **kw)
        tp, ts = adam_update(_port(g), ts, tp, 1e-2, **kw)
        _trees_close(tp, jp, TOL_ADAM)
        _trees_close(ts.m, js.m, TOL_ADAM)
        _trees_close(ts.v, js.v, TOL_ADAM)
        assert int(ts.step) == int(js.step) == step + 1
        assert all(leaf.dtype == torch.float64 for leaf in tree.leaves(tp))


def test_adam_rounds_float64_parameters_through_float32():
    p = {"w": torch.tensor([1.0 + 1e-12, math.pi], dtype=torch.float64)}
    g = {"w": torch.tensor([1e-3, -2e-3], dtype=torch.float64)}
    new, _ = adam_update(g, adam_init(p), p, 1e-3)
    assert tree.bit_equal(new["w"], new["w"].float().double())


def _rosenbrock(np_mod, x):
    a, b = x
    return (np_mod.sum((1.0 - a) ** 2) + 10.0 * np_mod.sum((b - a ** 2) ** 2))


def test_lbfgs_matches_reference_iterate_for_iterate():
    x0 = {"a": np.array([-1.2, 0.4, 2.0]), "b": np.array([1.0, -0.5, 3.1])}

    def jvg(p):
        return jax.value_and_grad(lambda q: _rosenbrock(jnp, (q["a"], q["b"])))(p)

    def tvg(p):
        leaves = [leaf.detach().requires_grad_() for leaf in tree.leaves(p)]
        q = tree.unflatten(p, leaves)
        f = _rosenbrock(torch, (q["a"], q["b"]))
        return f.detach(), tree.unflatten(p, list(torch.autograd.grad(f, leaves)))

    j_its, t_its = [], []
    want = jlbfgs(jvg, jax.tree_util.tree_map(jnp.asarray, x0), steps=12,
                  callback=lambda it, f, p: j_its.append(ravel_pytree(p)[0]))
    got = lbfgs(tvg, _port(x0), steps=12,
                callback=lambda it, f, p: t_its.append(tree.ravel(p)[0]))
    assert got.n_evals == want.n_evals
    assert len(got.loss_history) == len(want.loss_history)
    for a, b in zip(got.loss_history, want.loss_history):
        assert abs(a - b) <= TOL_LBFGS * max(abs(b), 1e-300)
    for a, b in zip(t_its, j_its):
        assert _rel(a, b) <= TOL_LBFGS
    assert got.loss_history[-1] < got.loss_history[0]


# ---------------------------------------------------------------------------
# pinn/trainer.py: the reference's draws replayed
# ---------------------------------------------------------------------------

def _burgers_draws(cfg):
    """The reference train()'s init and per-resample points."""
    key = jax.random.PRNGKey(cfg.seed)
    k_init, k_pts = jax.random.split(key)
    params = jinit_mlp(k_init, 1, cfg.width, cfg.depth, 1, dtype=jnp.float64)
    draws = {0: jcol.resample(k_pts, -cfg.domain, cfg.domain, cfg.n_domain,
                              cfg.n_origin, cfg.origin_radius, jnp.float64)}
    for step in range(1, cfg.adam_steps):
        if step % cfg.resample_every == 0:
            k_pts, sub = jax.random.split(k_pts)
            draws[step] = jcol.resample(sub, -cfg.domain, cfg.domain, cfg.n_domain,
                                        cfg.n_origin, cfg.origin_radius, jnp.float64)
    return params, draws


@pytest.mark.parametrize("engine", ["ntp", "ntp/cuda"])
def test_train_matches_reference_step_for_step(engine):
    kw = dict(k=1, width=8, depth=2, n_domain=32, n_origin=16, adam_steps=4,
              lbfgs_steps=3, resample_every=2, log_every=1)
    want = _reference(jtrainer.train, jtrainer.PINNRunConfig(**kw, engine="ntp"))
    cfg = ttrainer.PINNRunConfig(**kw, engine=engine)
    jparams, draws = _burgers_draws(cfg)
    got = ttrainer.train(
        cfg, device="cpu", init_params=_port(jparams),
        sampler=lambda step: tuple(torch.tensor(np.asarray(a)) for a in draws[step]))
    assert len(got.loss_history) == len(want.loss_history)
    for a, b in zip(got.loss_history, want.loss_history):
        assert abs(a - b) <= TOL_TRAIN * abs(b)
    assert len(got.lam_history) == len(want.lam_history)
    for a, b in zip(got.lam_history, want.lam_history):
        assert abs(a - b) <= TOL_TRAIN * abs(b)
    assert abs(got.lam - want.lam) <= TOL_TRAIN * want.lam
    _trees_close(got.params, want.params, 1e-5)
    assert got.n_params == want.n_params and got.order == want.order == 3
    assert got.target_lam == 0.5 and got.lbfgs_evals >= 3


def _operator_draws(cfg, net):
    op = jget_operator(cfg.op)
    key = jax.random.PRNGKey(cfg.seed)
    k_init, k_pts = jax.random.split(key)
    params = net.init(k_init, dtype=jnp.float64)
    draws = {0: jcol.sample_box(k_pts, op.domain, cfg.n_domain, jnp.float64)}
    for step in range(1, cfg.adam_steps):
        if step % cfg.resample_every == 0:
            k_pts, sub = jax.random.split(k_pts)
            draws[step] = jcol.sample_box(sub, op.domain, cfg.n_domain, jnp.float64)
    lbfgs_pts = jcol.sample_box(jax.random.PRNGKey(cfg.seed + 1), op.domain,
                                cfg.n_domain, jnp.float64)
    return params, draws, lbfgs_pts


@pytest.mark.parametrize("op,network,engine", [
    ("heat", "dense", "ntp"), ("heat", "dense", "ntp/cuda"),
    ("gray-scott", "dense", "ntp/cuda")])
def test_train_operator_matches_reference_step_for_step(op, network, engine):
    kw = dict(op=op, network=network, width=8, depth=2 if network == "dense" else 1,
              n_domain=24, n_bc=4, adam_steps=3, lbfgs_steps=2, resample_every=2,
              log_every=1, eval_pts_per_axis=6)
    if network == "transformer":
        kw["net_kwargs"] = {"n_heads": 2, "mlp_ratio": 2}
    want = _reference(jtrainer.train_operator,
                      jtrainer.OperatorRunConfig(**kw, engine="ntp"))
    cfg = ttrainer.OperatorRunConfig(**kw, engine=engine)
    jparams, draws, lbfgs_pts = _operator_draws(cfg, want.net)
    got = ttrainer.train_operator(
        cfg, device="cpu", init_params=_port(jparams),
        sampler=lambda step: torch.tensor(np.asarray(draws[step])),
        lbfgs_pts=torch.tensor(np.asarray(lbfgs_pts)))
    assert len(got.loss_history) == len(want.loss_history)
    for a, b in zip(got.loss_history, want.loss_history):
        assert abs(a - b) <= TOL_TRAIN * abs(b)
    assert abs(got.l2_error - want.l2_error) <= TOL_TRAIN * want.l2_error
    assert got.n_params == want.n_params and got.op_name == op


def test_trainers_draw_from_a_seeded_generator_by_default():
    cfg = ttrainer.OperatorRunConfig(op="poisson2d", width=4, depth=1, n_domain=16,
                                     n_bc=4, adam_steps=3, log_every=1,
                                     eval_pts_per_axis=4)
    a = ttrainer.train_operator(cfg, device="cpu")
    b = ttrainer.train_operator(cfg, device="cpu")
    assert a.loss_history == b.loss_history and a.loss_history[-1] < a.loss_history[0]
    res = ttrainer.train(ttrainer.PINNRunConfig(width=4, depth=1, n_domain=16,
                                                n_origin=8, adam_steps=2,
                                                lbfgs_steps=1), device="cpu")
    assert len(res.loss_history) >= 3 and all(math.isfinite(v) for v in res.loss_history)


def test_trainers_refuse_what_is_not_ported_and_default_to_the_card(monkeypatch, tmp_path):
    """The data-parallel fields are ported: without a process group (none
    is opened in this process) ``data_parallel`` raises with the launch
    command, a mesh that is not a ``DataMesh`` and compression without a
    mesh raise; over 2 gloo ranks (``tests/_torch_ranks.py``)
    ``train_operator(data_parallel=2)`` matches the single-process run on
    every logged loss at 1e-12.  The trainers default to the card."""
    import _torch_ranks
    for bad, match in ((dict(data_parallel=2), "torchrun --nproc-per-node 2"),
                       (dict(mesh=object()), "'data' axis"),
                       (dict(grad_compression="int8"), "needs data_parallel")):
        with pytest.raises(ValueError, match=match):
            ttrainer.train_operator(ttrainer.OperatorRunConfig(**bad), device="cpu")
    for res in _torch_ranks.spawn(2, "train_parity", tmp_path):
        assert len(res["single"]) == 4 + 3
        np.testing.assert_allclose(res["sharded"], res["single"], rtol=1e-12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.train_operator(ttrainer.OperatorRunConfig(adam_steps=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.train(ttrainer.PINNRunConfig(adam_steps=1))


def test_burgers_order_above_the_kernel_limit_raises_under_cuda():
    """k = 4 needs a u-jet of order 2k+2 = 10, past the kernels' templates
    (N1 <= 9).  Nothing caps it any more: under ntp/cuda it trains, step
    for step with the eager engine from the same init and draws."""
    cfg = ttrainer.PINNRunConfig(k=4, width=4, depth=1, n_domain=8, n_origin=4,
                                 adam_steps=2, lbfgs_steps=1, log_every=1)
    runs = {engine: ttrainer.train(dataclasses.replace(cfg, engine=engine), device="cpu")
            for engine in ("ntp/cuda", "ntp")}
    got, want = runs["ntp/cuda"], runs["ntp"]
    assert got.order == 9 and len(got.loss_history) == len(want.loss_history) >= 3
    for a, b in zip(got.loss_history + got.lam_history,
                    want.loss_history + want.lam_history):
        assert math.isfinite(a) and abs(a - b) <= TOL_TRAIN * abs(b)
