"""The port's transformer trunk against the JAX package: the jet ops it
reaches, the plain versions of K3 (``jet_rms_norm``) and K4
(``jet_flash_attention``), the trunk's modules, the ``Transformer``
network under both engines, the wrappers' backward, the bridge, the
server, and what the dispatch hands the CUDA launchers.

Inputs are made with numpy from a seed; JAX parameters cross over through
``repro_torch.bridge``.  The JAX side runs its jnp path and its Pallas
kernels in interpret mode.  Tolerance: float64 1e-12 relative to each
coefficient's (or table slice's) max |ref|.  Small sizes (width 8, depth
<= 2): the JAX trunk is the expensive side here.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import jet as JJ
from repro.core import modules as jmod
from repro.core.engines import NTPEngine as JNTP
from repro.core.network import Transformer as JTransformer
from repro.kernels import jet_attention as jka
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.core import jet as TJ
from repro_torch.core import modules as tmod
from repro_torch.core.engines import NTPEngine
from repro_torch.core.network import Transformer, make_network
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import jet_attention as tka
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.serving import DerivativeServer
from repro_torch.tree import bit_equal

TOL = 1e-12
# The trunk's derivative tables through order 4: with the init's zero
# embedding bias, RMSNorm of a token x_t * w is near-singular at x_t = 0,
# so the order-3/4 slices carry cancellation.  The reference's own jitted
# and eager runs of the depth-2 grid below differ by 2.8e-12 relative in
# the order-3 slice; 3e-11 leaves 10x that spread for the rounding order of
# another framework (the port reads 7.3e-12 in the worst slice).
TOL_TRUNK = 3e-11
MASKS = (None, "causal", ("local", 2))


def _close(got, want, tol=TOL, keep=1):
    """max |got - want| <= tol * max |want| over each slice of the leading
    ``keep`` axes."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    lead = want.shape[:keep]
    d = np.abs(got - want).reshape(lead + (-1,)).max(-1)
    s = np.maximum(np.abs(want).reshape(lead + (-1,)).max(-1), 1e-300)
    assert np.all(d <= tol * s), float((d / s).max())


def _rng(seed):
    return np.random.default_rng(seed)


def _stack(seed, shape, scale=0.5):
    return _rng(seed).normal(size=shape) * scale


def _jets(coeffs):
    return JJ.Jet(jnp.asarray(coeffs)), TJ.Jet(torch.tensor(coeffs))


def _mask_name(mask):
    return "none" if mask is None else mask if isinstance(mask, str) else \
        f"{mask[0]}{mask[1]}"


# ---------------------------------------------------------------------------
# core/jet.py: the ops the trunk reaches
# ---------------------------------------------------------------------------

def _positive(seed, shape):
    c = _stack(seed, shape)
    c[0] = 1.5 + np.abs(c[0])
    return c


def _masked_rows(fn):
    keep = np.tril(np.ones((4, 4), bool))
    keep[1] = False                     # a row that keeps nothing
    return fn(keep)


JET_OPS = {
    "reduce_sum": lambda J, a, b, m: J.reduce_sum(a, axis=-1, keepdims=True),
    "reduce_mean": lambda J, a, b, m: J.reduce_mean(a, axis=(0, 1)),
    "einsum_jet_jet": lambda J, a, b, m: J.einsum("qd,kd->qk", a, b),
    "einsum_jet_const": lambda J, a, b, m: J.einsum("qd,kd->qk", a, m),
    "exp": lambda J, a, b, m: J.exp(a),
    "div": lambda J, a, b, m: J.div(a, b),
    "powr": lambda J, a, b, m: J.powr(b, -1.5),
    "sqrt": lambda J, a, b, m: J.sqrt(b),
    "rsqrt": lambda J, a, b, m: J.rsqrt(b),
    "softmax": lambda J, a, b, m: J.softmax(a, axis=-1),
    "rms_norm": lambda J, a, b, m: J.rms_norm(a, m[0], eps=1e-6),
}


@pytest.mark.parametrize("name", sorted(JET_OPS))
def test_jet_op_matches_reference(name):
    a, b = _stack(1, (5, 4, 4)), _positive(2, (5, 4, 4))
    m = _stack(3, (4, 4))
    ja, ta = _jets(a)
    jb, tb = _jets(b)
    want = JET_OPS[name](JJ, ja, jb, jnp.asarray(m))
    got = JET_OPS[name](TJ, ta, tb, torch.tensor(m))
    _close(got.coeffs, want.coeffs)


def test_masked_softmax_matches_reference_and_empty_row_is_uniform():
    """Masked positions vanish at every order; a row that keeps nothing is
    uniform with zero higher coefficients, as in the reference."""
    ja, ta = _jets(_stack(4, (5, 4, 4)))
    want = _masked_rows(lambda k: JJ.softmax(ja, axis=-1, mask=jnp.asarray(k)))
    got = _masked_rows(lambda k: TJ.softmax(ta, axis=-1, mask=torch.tensor(k)))
    _close(got.coeffs, want.coeffs)
    c = got.coeffs.numpy()
    assert np.allclose(c[0, 1], 0.25) and np.all(c[1:, 1] == 0)
    assert np.all(c[:, 0, 1:] == 0)


def test_softmax_shift_carries_no_gradient():
    """The shift is detached (the reference's stop_gradient): gradients
    through the softmax jet match jax.vjp of the reference."""
    a, g = _stack(5, (4, 3, 5)), _stack(6, (4, 3, 5), 1.0)
    _, vjp = jax.vjp(lambda c: JJ.softmax(JJ.Jet(c), axis=-1).coeffs,
                     jnp.asarray(a))
    (want,) = vjp(jnp.asarray(g))
    ta = torch.tensor(a, requires_grad=True)
    (got,) = torch.autograd.grad(TJ.softmax(TJ.Jet(ta), axis=-1).coeffs, ta,
                                 torch.tensor(g))
    _close(got, want)


# ---------------------------------------------------------------------------
# kernels/ref.py: the plain versions of K3 and K4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order,bsz,width", [(1, 10, 8), (4, 7, 13), (8, 3, 6)])
def test_rms_norm_plain_matches_reference_and_pallas(order, bsz, width):
    x = _stack(order, (order + 1, bsz, width))
    g = _rng(10 + order).normal(size=(width,))
    got = tref.jet_rms_norm_ref(torch.tensor(x), torch.tensor(g), 1e-6)
    _close(got, jref.jet_rms_norm_ref(jnp.asarray(x), jnp.asarray(g), 1e-6))
    # the Pallas kernel in interpret mode, with a ragged last batch block
    _close(got, jka.jet_rms_norm_pallas(jnp.asarray(x), jnp.asarray(g), 1e-6,
                                        block_b=4, interpret=True))


FLASH_CASES = [(mask, t) for mask in MASKS for t in (2, 11)]


def _qkvo(seed, order, bsz, heads, t, dh, dm):
    rng = _rng(seed)
    q, k, v = (rng.normal(size=(order + 1, bsz, heads, t, dh)) * 0.5
               for _ in range(3))
    wo = rng.normal(size=(heads, dh, dm)) / math.sqrt(heads * dh)
    return q, k, v, wo


@pytest.mark.parametrize("mask,t", FLASH_CASES,
                         ids=[f"{_mask_name(m)}-T{t}" for m, t in FLASH_CASES])
def test_flash_attention_plain_matches_reference_and_pallas(mask, t):
    """T = 11 with 4-wide Pallas blocks spans three ragged q and KV blocks."""
    q, k, v, wo = _qkvo(20 + t, 3, 3, 2, t, 4, 5)
    scale = 0.5
    got = tref.jet_flash_attention_ref(
        *(torch.tensor(a) for a in (q, k, v, wo)), scale,
        mask=tmod.attention_mask(mask, t))
    dense = jmod.attention_mask(mask, t)
    _close(got, jref.jet_flash_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v, wo)), scale, mask=dense))
    kind, window = jmod.normalize_attention_mask(mask)
    _close(got, jka.jet_flash_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, wo)), scale, mask=kind,
        window=window, block_q=4, block_k=4, block_b=2, interpret=True))


@pytest.mark.parametrize("mask", MASKS, ids=_mask_name)
def test_attention_mask_matches_reference(mask):
    for t in (1, 2, 7):
        want = jmod.attention_mask(mask, t)
        got = tmod.attention_mask(mask, t)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tmod.normalize_attention_mask(mask) == \
        jmod.normalize_attention_mask(mask)
    assert tmod.ATTENTION_MASK_KINDS == jmod.ATTENTION_MASK_KINDS


def test_attention_mask_rejects_bad_specs():
    for bad in (("local", 0), "sliding", ("local",)):
        with pytest.raises(ValueError):
            tmod.normalize_attention_mask(bad)


# ---------------------------------------------------------------------------
# kernels/ops.py: the wrappers' backward and what reaches the launchers
# ---------------------------------------------------------------------------

def test_rms_norm_gradients_match_reference_vjp():
    x, g = _stack(30, (4, 2, 3, 6)), _rng(31).normal(size=(6,))
    ct = _stack(32, (4, 2, 3, 6), 1.0)
    flat = x.reshape(4, 6, 6)
    _, vjp = jax.vjp(lambda c, gg: jref.jet_rms_norm_ref(c, gg, 1e-6),
                     jnp.asarray(flat), jnp.asarray(g))
    want = vjp(jnp.asarray(ct.reshape(4, 6, 6)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, g)]
    got = torch.autograd.grad(tops.jet_rms_norm(*leaves, eps=1e-6), leaves,
                              torch.tensor(ct))
    _close(got[0].reshape(4, 6, 6), want[0])
    _close(got[1], want[1], keep=0)


@pytest.mark.parametrize("mask", MASKS, ids=_mask_name)
def test_flash_attention_gradients_match_reference_vjp(mask):
    q, k, v, wo = _qkvo(40, 3, 2, 2, 5, 3, 4)
    ct = _stack(41, (4, 2, 5, 4), 1.0)
    dense = jmod.attention_mask(mask, 5)
    _, vjp = jax.vjp(lambda *a: jref.jet_flash_attention_ref(*a, 0.6, mask=dense),
                     *(jnp.asarray(a) for a in (q, k, v, wo)))
    want = vjp(jnp.asarray(ct))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v, wo)]
    out = tops.jet_flash_attention(*leaves, 0.6, mask=mask)
    got = torch.autograd.grad(out, leaves, torch.tensor(ct))
    for gt, wt in zip(got, want):
        _close(gt, wt, keep=0)


def test_dispatch_hands_the_launchers_contiguous_stacks(monkeypatch):
    """With the CUDA branch forced on CPU tensors and the launch stubbed:
    the (B, T, H, Dh) projections that SelfAttention views as (B, H, T, Dh)
    reach the flash launcher as contiguous (n+1, B, H, T, Dh) stacks with
    extra batch axes folded, ``wo`` as (H, Dh, Dm), and each wrapper counts
    exactly one launch."""
    seen, calls = {}, []

    def check(t, name, ndim, dtype=None):
        assert t.ndim == ndim and (dtype is None or t.dtype == dtype)
        seen[name] = (tuple(t.shape), t.is_contiguous())

    monkeypatch.setattr(tops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(tka, "check_cuda_tensor", check)
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda name, device, *args: calls.append((name, args)))
    tops.reset_launch_counts()

    n1, lead, t, h, dh = 4, (2, 3), 5, 2, 3
    proj = [torch.tensor(_stack(50 + i, (n1,) + lead + (t, h * dh)))
            for i in range(3)]
    heads = [p.reshape(p.shape[:-1] + (h, dh)).movedim(-2, -3) for p in proj]
    assert not heads[0].is_contiguous()
    wo = torch.tensor(_stack(53, (h * dh, 7)))
    out = tops.jet_flash_attention(*heads, wo, 0.5, mask=("local", 2))
    assert out.shape == (n1,) + lead + (t, 7)
    for name in ("q", "k", "v"):
        assert seen[name] == ((n1, 6, h, t, dh), True)
    assert seen["wo"] == ((h, dh, 7), True)
    name, args = calls[-1]
    assert name == "jet_flash_attention_launch"
    geo = tka.flash_geometry(n1, h, t, dh, torch.float64)
    assert geo.group == 0          # T = 5: the long-T kernel
    assert args[5:] == (6, h, t, dh, 7, n1, 1, 0.5, 2, 2, 0, geo.rows,
                        geo.key_tile, geo.dpl)

    x = torch.tensor(_stack(54, (n1, 3, 5, 8))).transpose(1, 2)
    out = tops.jet_rms_norm(x, torch.ones(8, dtype=torch.float64), eps=1e-5)
    assert out.shape == x.shape
    assert seen["coeffs"] == ((n1, 15, 8), True)
    assert seen["gamma"] == ((8,), True)
    name, args = calls[-1]
    assert name == "jet_rms_norm_launch" and args[3:] == (15, 8, n1, 1, 1e-5)
    assert tops.launch_counts() == {"jet_dense": 0, "act_jet": 0,
                                    "jet_rms_norm": 1, "jet_flash_attention": 1,
                                    "jet_attention_scores": 0}


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    cpu = torch.zeros((2, 1, 1, 2, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tka.jet_flash_attention_cuda(cpu, cpu, cpu, torch.zeros((1, 4, 3)), 0.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tka.jet_rms_norm_cuda(cpu[:, 0, 0], torch.ones(4))
    # no order is capped on either device (parity at orders 10 and 12
    # below); on the card the run-time-order kernels refuse only what their
    # smallest block cannot hold: a warp of 2 n1 Dh + n1 Dm + 3 n1 words
    # (and they take head dims past the templates' 128).  Short T runs
    # groups of lanes: T = 3 pads to a team of 4 groups of 8 lanes, one
    # (row, head) a warp, two rows a block (four do not fit)
    geo = tka.flash_geometry(5, 2, 3, 160, torch.float32, 40)
    assert geo.runtime and (geo.group, geo.rows) == (8, 2)
    assert geo.smem == tka.flash_short_bytes(5, 2, 3, 160, 40, 2, torch.float32)
    assert not tka.flash_geometry(5, 2, 3, 128, torch.float32, 40).runtime
    over = tka.flash_geometry(9, 1, 70, 1611, torch.float64, 4)
    assert over.rows == 1 and over.smem == (18 * 1611 + 36 + 27) * 8 > tka._SMEM_LIMIT
    assert tka.flash_geometry(9, 1, 70, 1610, torch.float64, 4).smem <= tka._SMEM_LIMIT
    # the served shape runs the short-T kernel, 16 rows a block: shared
    # memory holds the 160 output rows of its projection, 2 heads x 16 dims
    # at an odd pitch of 33 words
    assert tka.flash_smem_bytes(5, 2, 2, 16, torch.float64) == 160 * 33 * 8


@pytest.mark.parametrize("order", [10, 12])
def test_rms_norm_high_orders_match_reference_and_pallas(order):
    """Orders past the CUDA templates, through the public op."""
    x = _stack(order, (order + 1, 2, 3, 6))
    g = _rng(10 + order).normal(size=(6,)) + 1.0
    got = tops.jet_rms_norm(torch.tensor(x), torch.tensor(g), eps=1e-6)
    flat = jnp.asarray(x.reshape(order + 1, 6, 6))
    _close(got.reshape(order + 1, 6, 6), jref.jet_rms_norm_ref(flat, jnp.asarray(g), 1e-6))
    _close(got.reshape(order + 1, 6, 6),
           jka.jet_rms_norm_pallas(flat, jnp.asarray(g), 1e-6, block_b=4, interpret=True))


@pytest.mark.parametrize("mask", MASKS, ids=_mask_name)
@pytest.mark.parametrize("order", [10, 12])
def test_flash_attention_high_orders_match_reference_and_pallas(order, mask):
    q, k, v, wo = _qkvo(30 + order, order, 2, 2, 5, 4, 3)
    got = tops.jet_flash_attention(*(torch.tensor(a) for a in (q, k, v, wo)), 0.5, mask)
    _close(got, jref.jet_flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v, wo)), 0.5,
                                             mask=jmod.attention_mask(mask, 5)))
    kind, window = jmod.normalize_attention_mask(mask)
    _close(got, jka.jet_flash_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, wo)), 0.5, mask=kind, window=window,
        block_q=4, block_k=4, block_b=2, interpret=True))


def test_flash_attention_bfloat16_matches_float32_plain():
    """bfloat16 stacks are computed in float32 and rounded once: the plain
    version on bfloat16 is the float32 one on the same rounded inputs."""
    q, k, v, wo = (torch.tensor(a, dtype=torch.float32).to(torch.bfloat16)
                   for a in _qkvo(40, 3, 2, 2, 3, 4, 5))
    got = tops.jet_flash_attention(q, k, v, wo, 0.5)
    want = tref.jet_flash_attention_ref(q.float(), k.float(), v.float(), wo.float(), 0.5)
    assert got.dtype == torch.bfloat16 and bit_equal(got, want.to(torch.bfloat16))
    x = torch.tensor(_stack(41, (4, 3, 6)), dtype=torch.float32).to(torch.bfloat16)
    g = torch.ones(6, dtype=torch.bfloat16)
    assert bit_equal(tops.jet_rms_norm(x, g),
                     tref.jet_rms_norm_ref(x.float(), g.float()).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# core/modules.py: the trunk's modules, primal and jet, both impls
# ---------------------------------------------------------------------------

MODULES = {
    "rms_norm": (lambda M: M.RMSNorm(8), (3, 2, 8)),
    "self_attention": (lambda M: M.SelfAttention(8, 2), (3, 2, 8)),
    "self_attention_causal": (lambda M: M.SelfAttention(8, 2, "causal"), (3, 4, 8)),
    "self_attention_local": (lambda M: M.SelfAttention(8, 2, ("local", 1)), (3, 4, 8)),
    "mlp_block": (lambda M: M.MLPBlock(8, 16, "tanh"), (3, 2, 8)),
    "coordinate_embedding": (lambda M: M.CoordinateEmbedding(2, 8), (3, 2)),
    "token_pool": (lambda M: M.TokenPool(), (3, 2, 8)),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_reference(name):
    make, shape = MODULES[name]
    jm, tm = make(jmod), make(tmod)
    jp = jm.init(jax.random.PRNGKey(7), dtype=jnp.float64)
    if name == "rms_norm":            # a gain other than the ones-init
        jp = jnp.asarray(_rng(8).uniform(0.5, 1.5, size=(8,)))
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    x = _stack(9, shape, 1.0)
    _close(tm.apply(tp, torch.tensor(x)), jm.apply(jp, jnp.asarray(x)), keep=0)
    c = _stack(10, (4,) + shape)
    for timpl, jimpl in (("torch", "jnp"), ("cuda", "pallas")):
        want = jm.jet_apply(jp, JJ.Jet(jnp.asarray(c)), impl=jimpl)
        got = tm.jet_apply(tp, TJ.Jet(torch.tensor(c)), impl=timpl)
        _close(got.coeffs, want.coeffs)


def test_trunk_modules_are_registered():
    for name in ("rms_norm", "self_attention", "mlp_block",
                 "coordinate_embedding", "token_pool"):
        assert name in tmod.module_names() and name in jmod.module_names()
    assert isinstance(tmod.make_module("self_attention", dim=4, n_heads=2,
                                       mask=["local", 3]).mask, tuple)


def test_coordinate_embedding_bias_only_on_coefficient_zero():
    m = tmod.CoordinateEmbedding(2, 3)
    w, b = torch.ones((2, 3), dtype=torch.float64), torch.full((2, 3), 5.0,
                                                                dtype=torch.float64)
    c = torch.zeros((3, 4, 2), dtype=torch.float64)
    out = m.jet_apply((w, b), TJ.Jet(c)).coeffs
    assert torch.all(out[0] == 5.0) and torch.all(out[1:] == 0.0)


# ---------------------------------------------------------------------------
# core/network.py: the Transformer under both engines
# ---------------------------------------------------------------------------

TKW = dict(d_in=2, width=8, depth=2, d_out=1, n_heads=2)
IMPLS = {"torch": "jnp", "cuda": "pallas"}
REQUESTS = [("grid", 4), ("cross", (0, 1)), ("cross", (0, 0, 1, 1)), ("grid", 10)]
_TABLES = {}


@pytest.fixture(scope="module")
def trunk():
    jnet = JTransformer(**TKW)
    jp = jnet.init(jax.random.PRNGKey(5), dtype=jnp.float64)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    x = _rng(6).uniform(-1, 1, size=(4, 2))
    return jnet, jp, Transformer(**TKW), tp, x


def _request(engine, net, params, x, kind, arg):
    return engine.grid(net, params, x, arg) if kind == "grid" else \
        engine.cross(net, params, x, arg)


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("kind,arg", REQUESTS)
def test_transformer_tables_match_reference(trunk, impl, kind, arg):
    """Each port impl against the reference's counterpart; grid(10), past
    the kernels' templated orders, against the reference's jnp path (its
    Pallas interpret mode adds only time there), computed once for both."""
    jnet, jp, tnet, tp, x = trunk
    ref_impl = "jnp" if arg == 10 else IMPLS[impl]
    if (ref_impl, kind, arg) not in _TABLES:
        f = jax.jit(lambda p, xx: _request(JNTP(ref_impl), jnet, p, xx, kind, arg))
        _TABLES[ref_impl, kind, arg] = np.asarray(f(jp, jnp.asarray(x)))
    got = _request(NTPEngine(impl), tnet, tp, torch.tensor(x), kind, arg)
    _close(got, _TABLES[ref_impl, kind, arg], TOL_TRUNK, keep=2 if kind == "grid" else 0)


@pytest.mark.parametrize("mask", MASKS[1:], ids=_mask_name)
def test_masked_transformer_kernel_path_matches_reference(mask):
    kw = dict(TKW, depth=1, mask=mask)
    jnet = JTransformer(**kw)
    jp = jnet.init(jax.random.PRNGKey(8), dtype=jnp.float64)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    x = _rng(9).uniform(-1, 1, size=(3, 2))
    want = jax.jit(lambda p, xx: JNTP("pallas").grid(jnet, p, xx, 3))(
        jp, jnp.asarray(x))
    got = NTPEngine("cuda").grid(Transformer(**kw), tp, torch.tensor(x), 3)
    _close(got, np.asarray(want), TOL_TRUNK, keep=2)


def test_transformer_is_registered_and_validates():
    net = make_network("transformer", d_in=3, d_out=2, width=8, depth=1,
                       n_heads=4, mask=["local", 2])
    assert isinstance(net, Transformer) and net.mask == ("local", 2)
    with pytest.raises(ValueError):
        Transformer(2, 9, 1, 1, n_heads=2)
    params = net.init(torch.Generator().manual_seed(0), dtype=torch.float64,
                      device="cpu")
    y = net.apply(params, torch.zeros((5, 3), dtype=torch.float64))
    assert y.shape == (5, 2)


def test_transformer_parameters_round_trip_through_bridge(trunk):
    """The JAX trunk's tree -- tuples of gains, {"wq","wk","wv","wo"}
    dicts and (w, b) pairs -- comes across leaf for leaf, keeps its
    structure and keys, matches the port's own init, and goes back."""
    jnet, jp, tnet, tp, _ = trunk
    jleaves, jdef = jax.tree_util.tree_flatten(jp)
    tleaves, tdef = jax.tree_util.tree_flatten(
        bridge.params_to_numpy(tp))
    assert str(jdef) == str(tdef)
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    own = tnet.init(torch.Generator().manual_seed(0), dtype=torch.float64,
                    device="cpu")
    assert sorted(bridge.leaf_keys(own)) == sorted(bridge.leaf_keys(tp))
    assert all(o.shape == t.shape for o, t in zip(
        jax.tree_util.tree_leaves(bridge.params_to_numpy(own)), tleaves))
    assert "1/1/wq" in bridge.leaf_keys(tp)


# ---------------------------------------------------------------------------
# serving/server.py: a network whose jets carry a token axis
# ---------------------------------------------------------------------------

def test_server_answers_transformer_requests(trunk):
    """Served ntp/cuda tables equal the direct engine call (rtol 1e-13)
    for concurrent requests of several sizes coalesced into buckets."""
    _, _, tnet, tp, _ = trunk
    rng = _rng(11)
    xs = [torch.tensor(rng.uniform(-1, 1, size=(n, 2))) for n in (3, 5, 6)]
    eng = NTPEngine("cuda")
    with DerivativeServer(tnet, tp, "ntp/cuda", device="cpu",
                          flush_window_s=0.05) as srv:
        assert srv.net_id == "Transformer(d_in=2,d_out=1)"
        results, errors = {}, []

        def client(i):
            try:
                results[i] = (srv.grid(xs[i], 2), srv.cross(xs[i], (0, 1)))
            except Exception as exc:                  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors
        assert srv.metrics()["batches"] <= 6
    for i, x in enumerate(xs):
        grid, cross = results[i]
        _close(grid, eng.grid(tnet, tp, x, 2), 1e-13, keep=2)
        _close(cross, eng.cross(tnet, tp, x, (0, 1)), 1e-13, keep=0)


def test_server_answers_trunk_grid_past_the_templates(trunk):
    """The served trunk's grid(10) (N1 = 11: the run-time-order K1, K3 and
    K4 on the card) equals the direct ntp/cuda engine call (rtol 1e-13),
    for two requests of different sizes in one bucket."""
    _, _, tnet, tp, _ = trunk
    rng = _rng(12)
    xs = [torch.tensor(rng.uniform(-1, 1, size=(n, 2))) for n in (2, 5)]
    eng = NTPEngine("cuda")
    with DerivativeServer(tnet, tp, "ntp/cuda", device="cpu",
                          flush_window_s=0.05) as srv:
        tables = [srv.grid(x, 10) for x in xs]
    for x, table in zip(xs, tables):
        assert table.shape == (2, 11, x.shape[0], 1)
        _close(table, eng.grid(tnet, tp, x, 10), 1e-13, keep=2)
