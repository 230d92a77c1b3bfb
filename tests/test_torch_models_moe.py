"""The port's MoE LM archs against the JAX package's (``tests/_torch_lm.py``
holds the harness, its modes and why its tolerances are what they are):
mixtral (every layer MoE, top-2, sliding window) and llama4 (dense and MoE
layers interleaved, top-1, 3 local : 1 global) at their reduced configs,
the balance loss included.  Then ``apply_moe`` alone: the reference's two
MoE tests on the port, and a training-mode case whose capacity binds,
held to the reference at float64 -- which tokens a full expert drops
depends on the order of the dispatch sort, so an unstable sort shows
here.  ``tests/test_torch_models_recurrent.py`` holds the recurrent
archs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_lm as H
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.models import moe

ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
CASES = [(arch, mode) for arch in ARCHS for mode in H.MODES]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_builds_the_reference_tree(arch):
    H.init_builds_the_reference_tree(arch)


@pytest.mark.parametrize("case", CASES, ids=H.case_id)
def test_forward_seq_matches_reference(case):
    H.forward_seq_matches_reference(*case)


@pytest.mark.parametrize("case", CASES, ids=H.case_id)
def test_train_loss_and_gradient_match_reference(case):
    H.train_loss_and_gradient_match_reference(*case)


@pytest.mark.parametrize("case", CASES, ids=H.case_id)
def test_prefill_and_decode_match_reference(case):
    H.prefill_and_decode_match_reference(*case)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_is_the_full_forward(arch):
    H.prefill_then_decode_is_the_full_forward(arch)


def _first_moe_layer(arch, mode):
    """(reference config, port config, the first MoE layer's parameters as
    numpy) of ``arch`` reduced."""
    jcfg, cfg = H.cfgs(arch, mode)
    params, _ = H.reference(arch, mode)
    j = jcfg.moe.period - 1
    lp = jax.tree_util.tree_map(lambda a: a[0], params["stack"]["groups"]["layers"][j]["moe"])
    return jcfg, cfg, lp


def _x(mode, shape=(4, 64), seed=4):
    _, cfg = H.cfgs("mixtral-8x7b", mode)
    return np.random.default_rng(seed).normal(size=shape + (cfg.d_model,)).astype(
        H.dtype_of(mode))


def test_moe_capacity_drops_are_bounded():
    """The reference's test on the port: training dispatch, near-uniform
    routing: the Switch aux near 1, most tokens survive the drops."""
    _, cfg, lp = _first_moe_layer("mixtral-8x7b", "float32")
    y, aux = moe.apply_moe(bridge.params_from_numpy(lp, device="cpu"), cfg,
                           torch.as_tensor(_x("float32")), training=True)
    assert y.shape == (4, 64, cfg.d_model)
    assert float(aux) > 0.5
    assert float(torch.any(y != 0, dim=-1).double().mean()) > 0.5


def test_moe_inference_dispatch_is_dropless():
    """The reference's test on the port: inference dispatch keeps every
    token, and a lone token (what decode routes) gets the joint routing's
    output."""
    _, cfg, lp = _first_moe_layer("mixtral-8x7b", "float32")
    p = bridge.params_from_numpy(lp, device="cpu")
    x = torch.as_tensor(_x("float32"))
    with torch.no_grad():
        y, _ = moe.apply_moe(p, cfg, x, training=False)
        y_tok = torch.stack([moe.apply_moe(p, cfg, x[:, t:t + 1], training=False)[0][:, 0]
                             for t in (0, 13)], 1)
    assert float(torch.any(y != 0, dim=-1).double().mean()) == 1.0
    np.testing.assert_allclose(y_tok.numpy(), y[:, (0, 13)].numpy(), rtol=2e-2, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_binding_capacity_matches_reference(arch):
    """Training dispatch at float64 (islands lifted in both packages) on
    (4, 64) tokens: 8 groups of 32 tokens, a capacity of ceil(32 k / 4 x
    1.25) slots an expert, which the skewed routing below overflows.  The
    output, the aux, and the input's and router's gradients equal the
    reference's within the float64 bound; the dropped tokens (zero rows,
    none with top-1 llama4 left over at top-2 mixtral) are the same ones."""
    jcfg, cfg, lp = _first_moe_layer(arch, "float64")
    # route most tokens to expert 0: shift the router's column toward the mean input
    x = _x("float64", seed=5) + 0.5
    lp = dict(lp, router=lp["router"].copy())
    lp["router"][:, 0] += 0.3 * np.sign(x.mean((0, 1)))
    n_loc = 4 * 64 // moe.DISPATCH_GROUPS
    g, loc, cap = moe.dispatch_geometry(cfg, 4 * 64, training=True)
    assert (g, loc) == (moe.DISPATCH_GROUPS, n_loc) and cap < n_loc
    top_e = np.argsort(-(x.reshape(g, loc, -1) @ lp["router"]), -1)[..., :cfg.moe.top_k]
    counts = np.stack([np.bincount(t.ravel(), minlength=cfg.moe.n_experts) for t in top_e])
    assert (counts > cap).sum() >= g // 2      # the capacity binds in most groups

    def ref_fn(p, x):
        y, aux = jmoe.apply_moe(p, jcfg, x, training=True)
        return jnp.sum(y * jnp.cos(x)) + aux, (y, aux)

    with H.islands("float64"):
        (_, (want_y, want_aux)), (g_p, g_x) = jax.jit(jax.value_and_grad(
            ref_fn, argnums=(0, 1), has_aux=True))(lp, jnp.asarray(x))
        p = bridge.params_from_numpy(lp, device="cpu")
        p["router"].requires_grad_()
        tx = torch.as_tensor(x).requires_grad_()
        y, aux = moe.apply_moe(p, cfg, tx, training=True)
        got_gr, got_gx = torch.autograd.grad(torch.sum(y * torch.cos(tx)) + aux,
                                             (p["router"], tx))
    dropped = ~np.any(np.asarray(want_y) != 0, axis=-1)
    assert dropped.any() or cfg.moe.top_k > 1
    assert np.array_equal(~torch.any(y != 0, dim=-1).numpy(), dropped)
    for got, want, what in ((y, want_y, "y"), (aux, want_aux, "aux"),
                            (got_gr, g_p["router"], "router grad"), (got_gx, g_x, "x grad")):
        H.close(got, want, H.TOL["float64"], what)
