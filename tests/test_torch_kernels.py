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
from repro_torch.kernels import bell_tables as tbell
from repro_torch.kernels import tanh_jet
from repro_torch.kernels.jet_dense import jet_dense_cuda
from repro_torch.kernels.tanh_jet import act_jet_cuda
from repro_torch.tree import bit_equal

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
    run-time kernels keep 2 (n+1) words an element (the stacks z and F;
    outputs go straight out, K1's GEMM staging shares F's room and the
    table can stay in device memory), 32 elements at least: at f64 a
    stack of 454 coefficients fits, one more is refused."""
    tk1 = importlib.import_module("repro_torch.kernels.jet_dense")
    for mod in (tanh_jet, tk1):
        monkeypatch.setattr(mod, "check_cuda_tensor", lambda *a, **k: None)
    assert tanh_jet.dense_smem(454, 32, 0, 8, 0) == 454 * 2 * 32 * 8 == tanh_jet.SMEM_LIMIT
    x = torch.zeros((455, 3, 4), dtype=torch.float64)
    w, b = torch.zeros((4, 2), dtype=torch.float64), torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match=r"needs 232960 bytes of shared memory .* a block "
                                         r"has 232448"):
        act_jet_cuda(x, "tanh")
    with pytest.raises(ValueError, match=r"needs 232960 bytes of shared memory"):
        jet_dense_cuda(x, w, b, "tanh")
    ok = torch.zeros((13, 3, 4), dtype=torch.float64)
    assert tops.act_jet(ok, "tanh").shape == ok.shape


def _table_bytes(n):
    ints, reals = tbell.runtime_table(n)
    return 4 * len(ints) + 8 * len(reals)


def test_dense_geometry_sizes_blocks_by_the_kernels_formula():
    """K1/K2's run-time blocks: a warp a (group of 32 lanes x lane_elems
    elements, slot of the schedule), at most 8; the tile shrinks until the
    grid covers the 132 SMs twice; K1's tile has up to 32 columns and whole
    units of 32 elements where it can; the bytes are the kernels' formula:
    z and F (n1 words an element), K1's GEMM staging in F's room, the
    table when staged."""
    f64 = torch.float64
    assert (tanh_jet.lane_elems(f64), tanh_jet.lane_elems(torch.float32),
            tanh_jet.lane_elems(torch.bfloat16)) == (4, 8, 8)
    table = _table_bytes(10)
    geo = tanh_jet.act_jet_geometry(11, f64, 8192 * 32)
    assert geo == (8, 0, 0, 8, True, tanh_jet.dense_smem(11, 8 * 32, 0, 8, table))
    assert geo.smem == 2 * 11 * 256 * 8 + table
    # Burgers k = 4's hidden layer: 512 rows x 24 columns shrink to a row a tile
    geo = tanh_jet.jet_dense_geometry(11, f64, 512, 24, 24, "tanh")
    assert (geo.tile, geo.cols, geo.kc, geo.warps, geo.staged) == (1, 24, 24, 4, True)
    stage = (16 + 24) * 24                  # x rows (11 padded to 16), then w, kc words each
    assert geo.smem == tanh_jet.dense_smem(11, 24, stage, 8, table) == 8 * (11 * 32 + stage) + table
    # the served layer at order 16: 8 rows x 32 columns, two groups x four slots
    geo = tanh_jet.jet_dense_geometry(17, f64, 8192, 32, 32, "tanh")
    assert (geo.tile, geo.cols, geo.kc, geo.warps, geo.staged) == (8, 32, 32, 8, True)
    assert geo.smem == 8 * (17 * 256 + (136 + 32) * 32) + _table_bytes(16)
    # rows of 24 columns keep whole units of 32 elements: 8 rows
    geo = tanh_jet.jet_dense_geometry(11, f64, 1 << 16, 24, 24, "tanh")
    assert (geo.tile, geo.warps) == (8, 8)
    # without an activation: no table and one slot
    geo = tanh_jet.jet_dense_geometry(11, f64, 8192, 32, 32, None)
    assert (geo.tile, geo.warps, geo.staged) == (16, 4, False)
    # bfloat16 computes in float32, eight elements a lane
    geo = tanh_jet.act_jet_geometry(5, torch.bfloat16, 8192 * 32)
    assert geo == (16, 0, 0, 6, True, tanh_jet.dense_smem(5, 16 * 32, 0, 4, _table_bytes(4)))


def test_dense_geometry_shrinks_before_it_refuses(monkeypatch):
    """Where a block does not fit: K1 halves kc first, then the rows, then
    leaves the table in device memory; K2 halves its tile, then leaves
    the table; only a block of 32 elements that does not fit is refused,
    and the message names its bytes."""
    f64, table = torch.float64, _table_bytes(16)
    stacks = 2 * 17 * 8                      # z and F, bytes an element at order 16
    served = 8 * (17 * 256 + (136 + 32) * 32) + table        # K1: 8 rows, kc 32
    monkeypatch.setattr(tanh_jet, "SMEM_LIMIT", served - 1)
    geo = tanh_jet.jet_dense_geometry(17, f64, 8192, 32, 32, "tanh")
    assert (geo.tile, geo.kc, geo.staged) == (8, 16, True)
    assert geo.smem == stacks * 256 + table          # the staging fits in F's room
    monkeypatch.setattr(tanh_jet, "SMEM_LIMIT", stacks * 256 + table - 1)
    geo = tanh_jet.act_jet_geometry(17, f64, 8192 * 32)
    assert (geo.tile, geo.staged, geo.smem) == (4, True, stacks * 128 + table)
    limit = stacks * 32 + table - 1          # not even 32 elements beside the table
    monkeypatch.setattr(tanh_jet, "SMEM_LIMIT", limit)
    geo = tanh_jet.act_jet_geometry(17, f64, 8192 * 32)
    units = max(u for u in (8, 4, 2, 1) if stacks * 32 * u <= limit)
    assert (geo.tile, geo.staged, geo.smem) == (units, False, stacks * 32 * units)
    geo = tanh_jet.jet_dense_geometry(17, f64, 8192, 32, 32, "tanh")
    assert not geo.staged and geo.smem <= limit
    monkeypatch.setattr(tanh_jet, "SMEM_LIMIT", stacks * 32 - 1)
    with pytest.raises(ValueError, match=r"act_jet kernel needs 8704 bytes of shared memory "
                                         r"for order 16 \(32 elements\)"):
        tanh_jet.act_jet_geometry(17, f64, 8192 * 32)
    with pytest.raises(ValueError, match=r"jet_dense kernel needs 8704 bytes of shared memory "
                                         r"for order 16 \(one row of 32 columns\)"):
        tanh_jet.jet_dense_geometry(17, f64, 8192, 32, 32, "tanh")


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
    assert bit_equal(got, tref.jet_dense_ref(c.float(), w.float(), b.float(), "tanh")
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
