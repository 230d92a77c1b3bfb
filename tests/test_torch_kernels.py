"""The port's kernel dispatch (repro_torch.kernels.ops) on CPU tensors --
where it runs the kernels' plain versions -- against the JAX package's
kernel dispatch (repro.kernels.ops), which runs the Pallas kernels in
interpret mode here.  The CUDA kernels themselves are held against the
same plain versions on the card by chip_smoke.py.

Tolerances: float64 1e-12 relative to each order's max |ref|; float32 1e-5
relative to each order's max, as tests/test_parity.py uses.  The JAX
outputs are cached per module: interpret-mode calls are slow."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tanh_jet
from repro_torch.kernels.jet_dense import jet_dense_cuda
from repro_torch.kernels.tanh_jet import act_jet_cuda

DTYPES = {"f64": (np.float64, torch.float64, 1e-12),
          "f32": (np.float32, torch.float32, 1e-5)}


def _inputs(seed, order, lead, width, dtype):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(order + 1,) + lead + (width,)) * 0.5).astype(dtype)


def _close_per_order(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    for k in range(want.shape[0]):
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k].astype(np.float64) - want[k]).max())
        assert err <= tol * scale, (k, err, scale)


@pytest.fixture(scope="module")
def jax_cache():
    return {}


ACT_CASES = [(act, dt, order, lead)
             for act in ("tanh", "sigmoid", "sin")
             for dt in ("f64", "f32")
             for order, lead in ((1, (5,)), (4, (2, 3)), (6, (7,)))]


@pytest.mark.parametrize("act,dt,order,lead", ACT_CASES)
def test_act_jet_matches_reference(jax_cache, act, dt, order, lead):
    np_dt, t_dt, tol = DTYPES[dt]
    x = _inputs(order, order, lead, 9, np_dt)
    key = ("act", act, dt, order, lead)
    if key not in jax_cache:
        jax_cache[key] = np.asarray(
            jax.jit(jops.act_jet, static_argnums=1)(jnp.asarray(x), act))
    got = tops.act_jet(torch.tensor(x), act)
    assert got.dtype == t_dt
    _close_per_order(got, jax_cache[key], tol)


DENSE_CASES = [(act, dt, order, lead)
               for act in (None, "tanh", "sigmoid", "sin")
               for dt in ("f64", "f32")
               for order, lead in ((2, (5,)), (4, (2, 3)))]


@pytest.mark.parametrize("act,dt,order,lead", DENSE_CASES)
def test_jet_dense_matches_reference(jax_cache, act, dt, order, lead):
    np_dt, t_dt, tol = DTYPES[dt]
    rng = np.random.default_rng(100 + order)
    x = _inputs(order, order, lead, 3, np_dt)
    w = (rng.normal(size=(3, 7)) / np.sqrt(3)).astype(np_dt)
    b = (rng.normal(size=(7,)) * 0.1).astype(np_dt)
    key = ("dense", act, dt, order, lead)
    if key not in jax_cache:
        jax_cache[key] = np.asarray(jax.jit(jops.jet_dense, static_argnums=3)(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act))
    got = tops.jet_dense(torch.tensor(x), torch.tensor(w), torch.tensor(b), act)
    assert got.shape == (order + 1,) + lead + (7,)
    _close_per_order(got, jax_cache[key], tol)


@pytest.mark.parametrize("act", ["tanh", "sin"])
def test_jet_dense_gradients_match_reference_vjp(act):
    """autograd through the port's jet_dense (backward recomputes through
    the plain version) equals jax.vjp through the reference custom_vjp."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 5, 3)) * 0.5
    w, b = rng.normal(size=(3, 6)) / np.sqrt(3), rng.normal(size=(6,)) * 0.1
    g = rng.normal(size=(4, 5, 6))
    _, vjp = jax.vjp(lambda c, ww, bb: jops.jet_dense(c, ww, bb, act),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = vjp(jnp.asarray(g))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    out = tops.jet_dense(*leaves, act)
    got = torch.autograd.grad(out, leaves, torch.tensor(g))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(wt).max()))


def test_act_jet_gradient_matches_reference_vjp():
    rng = np.random.default_rng(8)
    x, g = rng.normal(size=(5, 4, 6)) * 0.5, rng.normal(size=(5, 4, 6))
    _, vjp = jax.vjp(lambda c: jops.act_jet(c, "sigmoid"), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    (got,) = torch.autograd.grad(tops.act_jet(xt, "sigmoid"), xt, torch.tensor(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12 * float(np.abs(want).max()))


def test_order_limit_raises_naming_it(monkeypatch):
    """No order is capped: the CPU path takes orders 10 and 12 (parity
    below) and on the card the only refusal is a block whose working set
    does not fit in shared memory, named in bytes.  The dense path's
    run-time kernels keep 2 (n+1) words a thread, 32 threads at least: at
    f64 a stack of 454 coefficients fits, one more is refused."""
    tk1 = importlib.import_module("repro_torch.kernels.jet_dense")
    for mod in (tanh_jet, tk1):
        monkeypatch.setattr(mod, "check_cuda_tensor", lambda *a, **k: None)
    assert tanh_jet.runtime_threads(454, torch.float64) == (32, 454 * 2 * 32 * 8)
    x = torch.zeros((455, 3, 4), dtype=torch.float64)
    w, b = torch.zeros((4, 2), dtype=torch.float64), torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match=r"needs 232960 bytes of shared memory .* a block "
                                         r"has 232448"):
        act_jet_cuda(x, "tanh")
    with pytest.raises(ValueError, match=r"needs 232960 bytes of shared memory"):
        jet_dense_cuda(x, w, b, "tanh")
    ok = torch.zeros((13, 3, 4), dtype=torch.float64)
    assert tops.act_jet(ok, "tanh").shape == ok.shape


HIGH_ORDER_CASES = [(act, dt, order)
                    for act in ("tanh", "sigmoid", "sin")
                    for dt in ("f64", "f32") for order in (10, 12)]


@pytest.mark.parametrize("act,dt,order", HIGH_ORDER_CASES)
def test_act_jet_high_orders_match_reference(jax_cache, act, dt, order):
    """Orders past the CUDA templates, which the reference's Pallas kernel
    (interpret mode) takes from the stack's depth."""
    np_dt, t_dt, tol = DTYPES[dt]
    x = _inputs(order, order, (4,), 6, np_dt)
    key = ("act_high", act, dt, order)
    if key not in jax_cache:
        jax_cache[key] = np.asarray(jops.act_jet(jnp.asarray(x), act))
    _close_per_order(tops.act_jet(torch.tensor(x), act), jax_cache[key], tol)


@pytest.mark.parametrize("act", [None, "tanh", "sin"])
@pytest.mark.parametrize("order", [10, 12])
def test_jet_dense_high_orders_match_reference(jax_cache, act, order):
    rng = np.random.default_rng(200 + order)
    x = _inputs(order, order, (5,), 3, np.float64)
    w, b = rng.normal(size=(3, 7)) / np.sqrt(3), rng.normal(size=(7,)) * 0.1
    key = ("dense_high", act, order)
    if key not in jax_cache:
        jax_cache[key] = np.asarray(jops.jet_dense(jnp.asarray(x), jnp.asarray(w),
                                                   jnp.asarray(b), act))
    got = tops.jet_dense(torch.tensor(x), torch.tensor(w), torch.tensor(b), act)
    _close_per_order(got, jax_cache[key], 1e-12)


def test_bfloat16_path():
    """bfloat16 in, float32 arithmetic, bfloat16 out: the reference's
    tests/test_kernels.py::test_bfloat16_path, for act_jet and jet_dense,
    against the reference's own bfloat16 path (Pallas, interpret mode) and
    its float32 plain version on the same rounded inputs, at 5e-2."""
    rng = np.random.default_rng(9)
    c = torch.tensor(rng.normal(size=(4, 16, 64)) * 0.7, dtype=torch.float32).to(torch.bfloat16)
    c32 = c.float().numpy()
    got = tops.act_jet(c, "tanh")
    assert got.dtype == torch.bfloat16
    for want in (jops.act_jet(jnp.asarray(c32, jnp.bfloat16), "tanh"),
                 jref.act_jet_ref(jnp.asarray(c32), "tanh")):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=5e-2, atol=5e-2)
    w = torch.tensor(rng.normal(size=(64, 24)) / 8, dtype=torch.float32).to(torch.bfloat16)
    b = torch.tensor(rng.normal(size=(24,)) * 0.1, dtype=torch.float32).to(torch.bfloat16)
    got = tops.jet_dense(c, w, b, "tanh")
    assert got.dtype == torch.bfloat16
    w32, b32 = w.float().numpy(), b.float().numpy()
    for want in (jops.jet_dense(*(jnp.asarray(a, jnp.bfloat16) for a in (c32, w32, b32)), "tanh"),
                 jref.jet_dense_ref(jnp.asarray(c32), jnp.asarray(w32), jnp.asarray(b32), "tanh")):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=5e-2, atol=5e-2)
    # the plain version is the float32 computation on the same bfloat16 inputs
    assert torch.equal(got, tref.jet_dense_ref(c.float(), w.float(), b.float(), "tanh")
                       .to(torch.bfloat16))


def test_activation_without_kernel_table_raises():
    x = torch.zeros((3, 2, 4), dtype=torch.float64)
    w, b = torch.zeros((4, 2), dtype=torch.float64), torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="no kernel epilogue"):
        tops.jet_dense(x, w, b, "softplus")
    with pytest.raises(ValueError, match="no kernel epilogue"):
        tops.act_jet(x, None)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a non-CUDA tensor the kernel wrappers raise: they never run the
    plain version themselves (ops decides that, by device)."""
    x = torch.zeros((3, 2, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        act_jet_cuda(x, "tanh")
    with pytest.raises(ValueError, match="CUDA tensor"):
        jet_dense_cuda(x, torch.zeros((4, 2), dtype=torch.float64),
                       torch.zeros(2, dtype=torch.float64), "tanh")


def test_cpu_path_launches_nothing():
    tops.reset_launch_counts()
    x = torch.zeros((3, 2, 4), dtype=torch.float64)
    tops.act_jet(x, "tanh")
    tops.jet_dense(x, torch.zeros((4, 2), dtype=torch.float64),
                   torch.zeros(2, dtype=torch.float64), None)
    tops.jet_rms_norm(x, torch.ones(4, dtype=torch.float64))
    qkv = torch.zeros((3, 2, 2, 5, 4), dtype=torch.float64)
    tops.jet_flash_attention(qkv, qkv, qkv, torch.zeros((8, 3), dtype=torch.float64),
                             0.5, "causal")
    tops.jet_attention_scores(qkv[:, :, 0], qkv[:, :, 1], 0.5)
    assert tops.launch_counts() == {"jet_dense": 0, "act_jet": 0,
                                    "jet_rms_norm": 0, "jet_flash_attention": 0,
                                    "jet_attention_scores": 0}


def test_epilogue_registry_is_typed_and_read_only():
    """Every TPU kernel is ported: the port's registry equals the
    reference's, entry for entry of the same kind."""
    reg, jreg = tops.epilogues(), jops.epilogues()
    assert set(reg) == set(jreg)
    assert all(reg[name].value == jreg[name].value for name in reg)
    assert {n for n, k in reg.items() if k is tops.EpilogueKind.ACTIVATION} \
        == set(tanh_jet.KERNEL_ACTS)
    with pytest.raises(TypeError):
        reg["relu"] = tops.EpilogueKind.ACTIVATION


def test_fold_batch_roundtrip():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float64).reshape(2, 3, 4, 5)
    flat, batch = tops._fold_batch(x)
    assert flat.shape == (2, 12, 5) and batch == (3, 4)
    jflat, jbatch = jops._fold_batch(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert tuple(jbatch) == batch


def test_plain_versions_match_core_jet_algebra():
    """ref.py is independent of core.jet; both must agree."""
    from repro_torch.core import jet as TJ
    x = torch.tensor(_inputs(3, 5, (4,), 6, np.float64))
    for act in ("tanh", "sigmoid", "sin"):
        np.testing.assert_allclose(tref.act_jet_ref(x, act).numpy(),
                                   TJ.compose(TJ.Jet(x), act).coeffs.numpy(),
                                   rtol=1e-12, atol=1e-12)
