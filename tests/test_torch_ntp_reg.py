"""The port's jet-Sobolev LM regularizer (``repro_torch.launch.ntp_reg``):
the order-n jet of the dense block stack along an embedding direction.

* against nested ``torch.func.jvp`` of the port's own order-0 forward
  (``dense_primal``: the same block math on a plain tensor; an order-0 jet
  is the standard computation, so nested forward-mode autodiff through it
  is an independent oracle for orders >= 1), through order 3 at float64,
  within 1e-10 of each order's max;
* against the reference's ``jet_forward_dense`` on the same parameters
  (carried across by ``repro_torch.bridge``), within 1e-11 with the float32
  RoPE island lifted to float64 in both packages, and for qwen3 within 1e-6
  with the reference as it is (torch and XLA round the island's cosines
  differently, and gemma2's and whisper's jets move by 2.4e-6 and 1.2e-6
  with it: see ``tests/_torch_lm.py``);
* ``ntp_smoothness`` is finite, >= 0 and has a nonzero gradient; a
  non-dense arch raises ``NotImplementedError``.

Archs: qwen3 (global attention, qk_norm, SwiGLU), gemma2 (local/global,
attention softcap, GeGLU) and whisper (the decoder's gelu MLP; the jet
runs the decoder's blocks without cross-attention, as the reference's).
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_lm as H
from repro.configs import get_arch as jget_arch
from repro.launch import ntp_reg as jntp_reg
from repro.models import init_model as jinit_model
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import jet as J
from repro_torch.launch.ntp_reg import (REG_TOKENS, dense_primal, jet_forward_dense,
                                        ntp_smoothness)
from repro_torch.models.layers import embed

ARCHS = ("qwen3-0.6b", "gemma2-27b", "whisper-large-v3")
ORDER = 3
TOL_ORACLE = 1e-10
TOL = {"float64-islands": 1e-6, "float64": 1e-11}


@lru_cache(maxsize=None)
def _setup(arch):
    """(port cfg, port params, tokens, direction, reference jets by mode)."""
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), dtype="float64")
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float64")
    jparams, _ = jinit_model(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 8))
    v = rng.normal(size=(2, 8, cfg.d_model)) * 0.1
    ref = {}
    for mode in TOL:
        with H.islands(mode):
            jet = jntp_reg.jet_forward_dense(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                                             ORDER, direction=jnp.asarray(v))
        ref[mode] = np.asarray(jet.coeffs)
    params = bridge.params_from_numpy(H.as_numpy(jparams), device="cpu")
    return cfg, params, torch.as_tensor(toks), torch.as_tensor(v), ref


@pytest.mark.parametrize("arch", ARCHS)
def test_jet_matches_nested_jvp_of_the_primal(arch):
    cfg, params, toks, v, _ = _setup(arch)
    x0 = embed(params["embed"], toks, cfg)
    ours = J.derivatives(jet_forward_dense(params, cfg, toks, ORDER, direction=v))

    def h(t):
        return dense_primal(params, cfg, x0 + t * v)

    t0 = torch.zeros((), dtype=torch.float64)
    f = h
    for k in range(ORDER + 1):
        want = f(t0)
        H.close(ours[k], want, TOL_ORACLE, f"order {k}")
        f = (lambda g: lambda t: torch.func.jvp(g, (t,), (torch.ones_like(t),))[1])(f)


@pytest.mark.parametrize("arch, mode", [(arch, "float64") for arch in ARCHS]
                         + [("qwen3-0.6b", "float64-islands")])
def test_jet_matches_the_reference(arch, mode):
    cfg, params, toks, v, ref = _setup(arch)
    with H.islands(mode):
        got = jet_forward_dense(params, cfg, toks, ORDER, direction=v).coeffs
    for k in range(ORDER + 1):
        H.close(got[k], ref[mode][k], TOL[mode], f"coefficient {k}")


def test_default_direction_matches_the_reference():
    """The direction ntp_smoothness uses: sign(sin(i)) / sqrt(d)."""
    cfg, params, toks, _, _ = _setup("qwen3-0.6b")
    jcfg = dataclasses.replace(jget_arch("qwen3-0.6b").reduced(), dtype="float64")
    jparams = jax.tree_util.tree_map(jnp.asarray, bridge.params_to_numpy(params))
    with H.islands("float64"):
        want = jntp_reg.jet_forward_dense(jparams, jcfg, jnp.asarray(toks, jnp.int32), 2)
        got = jet_forward_dense(params, cfg, toks, 2)
    H.close(got.coeffs, np.asarray(want.coeffs), TOL["float64"], "default direction")


def test_ntp_smoothness_scalar_and_grad():
    cfg, params, toks, _, _ = _setup("qwen3-0.6b")
    batch = {"tokens": torch.cat([toks] * (REG_TOKENS // toks.shape[1] + 1), dim=1)}
    assert batch["tokens"].shape[1] > REG_TOKENS     # the penalty rides the first slice
    p = bridge.tree_map(lambda _, t: t.clone().requires_grad_(), params)
    val = ntp_smoothness(p, cfg, batch, 2)
    assert val.ndim == 0 and torch.isfinite(val) and float(val.detach()) >= 0
    by_key = bridge.by_key(p)
    grads = torch.autograd.grad(val, list(by_key.values()), allow_unused=True)
    gn = sum(float(g.abs().sum()) for g in grads if g is not None)
    assert np.isfinite(gn) and gn > 0


def test_rejects_non_dense():
    cfg = get_arch("rwkv6-3b").reduced()
    with pytest.raises(NotImplementedError, match="dense attention archs only"):
        jet_forward_dense({}, cfg, torch.zeros((1, 4), dtype=torch.long), 2)
    cfg = get_arch("mixtral-8x7b").reduced()
    with pytest.raises(NotImplementedError, match="dense attention archs only"):
        jet_forward_dense({}, cfg, torch.zeros((1, 4), dtype=torch.long), 2)
