"""K5, the materializing attention-score jet, against the JAX package: the
plain version (``ref.jet_attention_scores_ref``) and the public op
(``ops.jet_attention_scores``) against the reference's straight-line
oracle, its Pallas kernel in interpret mode and the jet algebra
(softmax of the scaled Cauchy einsum); batch-axis folding, the backward
against ``jax.vjp``, the row-sum invariant, the launch counter and
registry entry, and what the dispatch hands the CUDA launcher.  Without a
card: the kernel's tiling (``jet_attention.scores_geometry``) at its
limits, and a plain-torch emulation of the kernel's arithmetic (online-max
totals over key tiles, the merge of the lanes and key slices, the p
recurrence over the e-jet) against the plain version.

Inputs are made with numpy from a seed.  Tolerances: float64 1e-12 and
float32 1e-5, relative to each coefficient's max |ref|.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import jet as JJ
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.jet_attention import jet_attention_scores_pallas
from repro_torch.core import jet as TJ
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import jet_attention as tka
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.tree import bit_equal

TOL = {np.float64: 1e-12, np.float32: 1e-5}
# the reference's own test shapes (tests/test_kernels.py): ragged T, T = 1,
# D = 1
DIMS = [(5, 3, 4), (19, 2, 8), (3, 1, 1)]


def _close(got, want, tol, keep=1):
    """max |got - want| <= tol * max |want| over each slice of the leading
    ``keep`` axes."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    lead = want.shape[:keep]
    d = np.abs(got - want).reshape(lead + (-1,)).max(-1)
    s = np.maximum(np.abs(want).reshape(lead + (-1,)).max(-1), 1e-300)
    assert np.all(d <= tol * s), float((d / s).max())


def _qk(seed, order, shape, dtype=np.float64, scale=0.6):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(order + 1,) + shape) * scale for _ in range(2))
    return q.astype(dtype), k.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("order", [1, 8])
@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
def test_plain_version_matches_reference_and_pallas(dims, order, dtype):
    b, t, d = dims
    q, k = _qk(order * 7 + b, order, (b, t, d), dtype)
    scale = 1.0 / math.sqrt(d)
    got = tref.jet_attention_scores_ref(torch.tensor(q), torch.tensor(k), scale)
    assert got.dtype == torch.from_numpy(q).dtype
    want = jref.jet_attention_scores_ref(jnp.asarray(q), jnp.asarray(k), scale)
    _close(got, want, TOL[dtype])
    pallas = jet_attention_scores_pallas(jnp.asarray(q), jnp.asarray(k), scale,
                                         block_b=8, interpret=True)
    _close(got, pallas, TOL[dtype])


@pytest.mark.parametrize("order", [5, 6])
@pytest.mark.parametrize("tok_d", [(1, 1), (1, 4), (3, 1)])
def test_op_matches_jet_algebra(order, tok_d):
    """The fused op equals softmax(scale * Q K^T) through the jet algebra,
    the port's and the reference's, at the degenerate single-token and
    d_head = 1 shapes (mirrors tests/test_engines.py)."""
    t, d = tok_d
    q, k = _qk(order * 13 + t, order, (2, t, d))
    scale = 1.0 / math.sqrt(d)
    fused = tops.jet_attention_scores(torch.tensor(q), torch.tensor(k), scale)
    port = TJ.softmax(TJ.scale(TJ.einsum("bqd,bkd->bqk", TJ.Jet(torch.tensor(q)),
                                         TJ.Jet(torch.tensor(k))), scale))
    ref = JJ.softmax(JJ.scale(JJ.einsum("bqd,bkd->bqk", JJ.Jet(jnp.asarray(q)),
                                        JJ.Jet(jnp.asarray(k))), scale))
    _close(fused, port.coeffs, 1e-12)
    _close(fused, ref.coeffs, 1e-12)


def test_op_folds_batch_axes_like_the_reference():
    """(n+1, B, H, T, D) stacks fold to (n+1, B*H, T, D) and unfold on the
    way out; the reference's op (Pallas in interpret mode) agrees."""
    q, k = _qk(3, 3, (2, 3, 5, 4))
    got = tops.jet_attention_scores(torch.tensor(q), torch.tensor(k), 0.5)
    assert got.shape == (4, 2, 3, 5, 5)
    flat = tref.jet_attention_scores_ref(torch.tensor(q.reshape(4, 6, 5, 4)),
                                         torch.tensor(k.reshape(4, 6, 5, 4)), 0.5)
    np.testing.assert_array_equal(got.reshape(4, 6, 5, 5).numpy(), flat.numpy())
    _close(got, jops.jet_attention_scores(jnp.asarray(q), jnp.asarray(k), 0.5), 1e-12)


def test_gradients_match_reference_vjp():
    q, k = _qk(21, 3, (2, 3, 4, 5))
    ct = np.random.default_rng(22).normal(size=(4, 2, 3, 4, 4))
    # the reference op's custom_vjp backward is the vjp of its plain version
    _, vjp = jax.vjp(lambda a, b: jref.jet_attention_scores_ref(a, b, 0.7),
                     jnp.asarray(q.reshape(4, 6, 4, 5)), jnp.asarray(k.reshape(4, 6, 4, 5)))
    want = vjp(jnp.asarray(ct.reshape(4, 6, 4, 4)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k)]
    out = tops.jet_attention_scores(*leaves, 0.7)
    got = torch.autograd.grad(out, leaves, torch.tensor(ct))
    for gt, wt in zip(got, want):
        _close(gt.reshape(wt.shape), wt, 1e-12, keep=0)


@pytest.mark.parametrize("order", [1, 6])
def test_rows_sum_to_one_then_zero(order):
    """Probability rows sum to 1 at order 0 and to 0 at every higher order
    (the softmax's invariant), relative to each row's absolute mass."""
    q, k = _qk(order, order, (7, 9, 3))
    p = tops.jet_attention_scores(torch.tensor(q), torch.tensor(k), 0.5)
    sums = p.sum(-1)
    mass = p.abs().sum(-1)
    assert torch.all((sums[0] - 1).abs() <= 1e-12)
    assert torch.all(sums[1:].abs() <= 1e-12 * mass[1:].clamp_min(1.0))


def test_registry_entry_and_counter_on_the_cpu_path():
    assert tops.epilogues()["attention_scores"] is tops.EpilogueKind.FUSED_OP
    assert jops.epilogues()["attention_scores"].value == "fused_op"
    tops.reset_launch_counts()
    q = torch.zeros((3, 2, 4, 5), dtype=torch.float64)
    tops.jet_attention_scores(q, q, 0.5)
    counts = tops.launch_counts()
    assert counts["jet_attention_scores"] == 0 and set(counts) == {
        "jet_dense", "act_jet", "jet_rms_norm", "jet_flash_attention",
        "jet_attention_scores"}
    assert "jet_attention_scores" in tops.__all__
    from repro_torch import kernels
    assert kernels.jet_attention_scores is tops.jet_attention_scores


def test_dispatch_hands_the_launcher_contiguous_folded_stacks(monkeypatch):
    """With the CUDA branch forced on CPU tensors and the launch stubbed:
    non-contiguous (n+1, B, H, T, D) stacks reach the score launcher as
    contiguous (n+1, B*H, T, D) ones, the output is allocated (n+1, B*H, T,
    T) and unfolded, and the wrapper counts exactly one launch."""
    seen, calls = {}, []

    def check(t, name, ndim, dtype=None):
        assert t.ndim == ndim and (dtype is None or t.dtype == dtype)
        seen[name] = (tuple(t.shape), t.is_contiguous())

    monkeypatch.setattr(tops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(tka, "check_cuda_tensor", check)
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda name, device, *args: calls.append((name, args)))
    tops.reset_launch_counts()

    n1, lead, t, d = 4, (2, 3), 5, 6
    # (n+1, 2, T, 3, D) viewed as (n+1, 2, 3, T, D)
    q, k = (torch.tensor(a).transpose(2, 3)
            for a in _qk(60, n1 - 1, (lead[0], t, lead[1], d)))
    assert q.shape == (n1,) + lead + (t, d) and not q.is_contiguous()
    out = tops.jet_attention_scores(q, k, 0.25)
    assert out.shape == (n1,) + lead + (t, t)
    assert seen["q"] == ((n1, 6, t, d), True) and seen["k"] == ((n1, 6, t, d), True)
    name, args = calls[-1]
    assert name == "jet_attention_scores_launch"
    assert args[3:9] == (6, t, d, n1, 1, 0.25)
    geo = tka.scores_geometry(n1, t, d, torch.float64, 6)
    assert args[9:] == (geo.groups, geo.split, geo.tiles, geo.ring)
    assert tops.launch_counts()["jet_attention_scores"] == 1


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    cpu = torch.zeros((2, 1, 3, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tka.jet_attention_scores_cuda(cpu, cpu, 0.5)
    # no order is capped on either device (parity at orders 10 and 12
    # below); past the templates the tiled run-time block takes (11, T 3,
    # D 16): one warp, the row in one stage, its queries and keys (11
    # coefficients, 4 chunks of 4 dims), the lanes' jets and totals, the
    # group's totals and 1/m; where no tiled block fits, the smallest block,
    # a warp a query keeping n1 (D + 65) words, and a block whose one warp
    # does not fit is refused, naming the bytes
    assert tka.scores_runtime_geometry(11, 3, 16, torch.float64, 1) == (
        1, 1, 1, 1, (2 * 11 * 4 * 32 + (5 * 11 + 1) * 32 + 12 * 8 + 11) * 8)
    monkeypatch.setattr(tka, "check_cuda_tensor", lambda *a: None)
    big = torch.zeros((11, 1, 3, 2577), dtype=torch.float64)
    with pytest.raises(ValueError, match=r"needs 232496 bytes of shared memory"):
        tka.jet_attention_scores_cuda(big, big, 0.5)
    # the queries, two stages of one 8-key tile, the merge slots: 9
    # coefficients, 4 chunks of 4 dims
    assert tka.scores_smem_bytes(9, 16, 1, 1, 1, 2, 8) == (9 * 4 * 32 * 3 + 8 * 10) * 8


@pytest.mark.parametrize("order", [10, 12])
def test_high_orders_match_reference_and_pallas(order):
    """Orders past the CUDA templates, through the public op, against the
    reference's oracle and its Pallas kernel (interpret mode)."""
    q, k = _qk(50 + order, order, (2, 2, 5, 4))
    got = tops.jet_attention_scores(torch.tensor(q), torch.tensor(k), 0.5)
    flat = [jnp.asarray(a.reshape(order + 1, 4, 5, 4)) for a in (q, k)]
    want = jref.jet_attention_scores_ref(*flat, 0.5)
    _close(got.reshape(order + 1, 4, 5, 5), want, TOL[np.float64])
    _close(got.reshape(order + 1, 4, 5, 5),
           jet_attention_scores_pallas(*flat, 0.5, interpret=True), TOL[np.float64])


def test_bfloat16_is_the_float32_plain_version_rounded():
    q, k = (torch.tensor(a, dtype=torch.float32).to(torch.bfloat16)
            for a in _qk(60, 3, (2, 5, 4)))
    got = tops.jet_attention_scores(q, k, 0.5)
    want = tref.jet_attention_scores_ref(q.float(), k.float(), 0.5).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and bit_equal(got, want)


# ---------------------------------------------------------------------------
# the kernel's tiling (jet_attention.scores_geometry), checked without a card
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448          # shared memory a block can use on Hopper
GEO_SHAPES = [(4, 1024, 8), (4, 256, 8), (4, 64, 8), (5, 3, 4), (19, 2, 8), (3, 1, 1),
              (2, 70, 16), (3, 31, 1), (3, 33, 64), (1, 70, 128), (1, 4096, 8), (64, 2, 8)]
GEO_IDS = ["x".join(map(str, s)) for s in GEO_SHAPES]


def _bytes(n1, d, groups, split, tiles, ring, item):
    """The block's shared memory, written out: one 8 x 4 fragment per
    coefficient and 4-dim chunk for each query group and for each 8-key
    tile of each stage, and (max, N1 totals) per query of each warp."""
    frag = n1 * -(-d // 4) * 32
    return item * (groups * frag + ring * split * tiles * frag + groups * split * 8 * (n1 + 1))


def _visits(t, geo):
    """How often the kernel's indexing visits each (query, key) of one batch
    row (csrc/jet_attention_scores.cu: blocks of `groups` query groups,
    warp = group * split + slice, tile slice * tiles + nt of each stage)."""
    qblocks = -(-(-(-t // 8)) // geo.groups)
    ktb = geo.split * geo.tiles * 8
    nstages = -(-t // ktb)
    seen = np.zeros((t, t), dtype=np.int64)
    for blk in range(qblocks):
        for warp in range(geo.groups * geo.split):
            g, ks = divmod(warp, geo.split)
            q0 = (blk * geo.groups + g) * 8
            if q0 >= t:
                continue
            for st in range(nstages):
                for nt in range(geo.tiles):
                    key0 = st * ktb + (ks * geo.tiles + nt) * 8
                    if key0 >= t:
                        break
                    seen[q0:q0 + 8, key0:key0 + 8] += 1
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n1", [1, 3, 5, 9])
@pytest.mark.parametrize("shape", GEO_SHAPES, ids=GEO_IDS)
def test_scores_geometry_fits_a_block(shape, n1, dtype):
    """Every choice fits the 232,448 bytes of a block, at the size the
    kernel's formula gives, with no more warps than its launch bound, and
    stages the whole row in one stage only where one stage holds it."""
    b, t, d = shape
    geo = tka.scores_geometry(n1, t, d, dtype, b)
    item = 8 if dtype == torch.float64 else 4
    assert geo.smem == _bytes(n1, d, *geo[:4], item) <= SMEM_LIMIT
    assert geo.groups * geo.split <= (8 if dtype == torch.float64 and n1 >= 8 else 16)
    assert geo.ring in (1, 2)
    assert geo.whole == (geo.ring == 1)
    if geo.whole:
        assert geo.split * geo.tiles * 8 >= t


@pytest.mark.parametrize("n1,dtype", [(3, torch.float64), (9, torch.float64),
                                      (3, torch.float32)], ids=["f64-3", "f64-9", "f32-3"])
@pytest.mark.parametrize("shape", GEO_SHAPES[:-2], ids=GEO_IDS[:-2])
def test_scores_geometry_covers_every_key_once(shape, n1, dtype):
    """The blocks, warps, stages and tiles of the chosen geometry visit
    every (query, key) pair of a row exactly once."""
    b, t, d = shape
    geo = tka.scores_geometry(n1, t, d, dtype, b)
    np.testing.assert_array_equal(_visits(t, geo), 1)


@pytest.mark.parametrize("groups,split,tiles,ring", [(1, 1, 1, 2), (2, 4, 2, 2), (4, 2, 4, 2),
                                                    (1, 8, 1, 1), (3, 2, 5, 1), (1, 16, 2, 2)])
@pytest.mark.parametrize("t", [1, 7, 8, 9, 70, 257])
def test_kernel_indexing_covers_every_key_once_for_any_geometry(t, groups, split, tiles,
                                                                 ring):
    geo = tka.ScoresGeometry(groups, split, max(tiles, -(-t // (8 * split)) if ring == 1
                                                else tiles), ring, 0)
    np.testing.assert_array_equal(_visits(t, geo), 1)


def test_scores_geometry_at_the_timed_shapes():
    """(4, 1024, 8): 4 query groups a block share each key stage (128
    blocks); at order 2 the row's keys fit one stage, at order 8 (f64, 8
    warps a block) a ring of two; (4, 256, 8): one group, keys split over 8
    warps, the whole row."""
    f64 = torch.float64
    assert tuple(tka.scores_geometry(3, 1024, 8, f64, 4))[:4] == (4, 4, 32, 1)
    assert tuple(tka.scores_geometry(9, 1024, 8, f64, 4))[:4] == (4, 2, 4, 2)
    assert tuple(tka.scores_geometry(3, 256, 8, f64, 4))[:4] == (1, 8, 4, 1)
    assert tuple(tka.scores_geometry(9, 256, 8, f64, 4))[:4] == (1, 8, 4, 1)
    assert tuple(tka.scores_geometry(3, 1024, 8, torch.float32, 4))[:4] == (4, 4, 32, 1)


def test_scores_smem_bytes_is_the_kernels_formula():
    """scores_smem_bytes against csrc/jet_attention_scores.cu::smem_bytes,
    evaluated from its source, and against the layout written out here."""
    import re
    src = (cuda_lib.CSRC / "jet_attention_scores.cu").read_text()
    m = re.search(r"int64_t smem_bytes\(int n1, int nch, int groups, int split, int tiles, "
                  r"int ring, int item\) \{\s*return (.*?);\s*\}", src, re.S)
    assert m, "smem_bytes not found"
    expr = " ".join(m.group(1).replace("static_cast<int64_t>", "").split())
    for n1, d, groups, split, tiles, ring, item in [
            (1, 1, 1, 1, 1, 1, 4), (9, 8, 4, 2, 4, 2, 8), (3, 70, 2, 8, 3, 2, 4),
            (5, 13, 1, 16, 2, 2, 8), (3, 8, 4, 4, 32, 1, 8), (2, 5, 1, 2, 7, 1, 4)]:
        env = dict(n1=n1, nch=-(-d // 4), groups=groups, split=split, tiles=tiles,
                   ring=ring, item=item)
        got = tka.scores_smem_bytes(n1, d, groups, split, tiles, ring, item)
        assert got == eval(expr, env) == _bytes(n1, d, groups, split, tiles, ring, item)
    assert re.search(r"constexpr int kMaxWarps = (\d+);", src).group(1) == str(
        tka._SCORES_MAX_WARPS)
    # the launcher takes rings of 1 and 2 stages, what scores_geometry picks
    assert re.search(r"constexpr int kMaxRing = (\d+);", src).group(1) == "2"


def test_wrapper_refuses_what_no_geometry_fits(monkeypatch):
    """At order 8, f64, T = 70 every head dim up to the largest that fits is
    admitted; one more is refused, naming the limit."""
    monkeypatch.setattr(tka, "check_cuda_tensor", lambda *a: None)
    fits = [d for d in range(1, 400)
            if tka.scores_geometry(9, 70, d, torch.float64, 1).smem <= SMEM_LIMIT]
    d_max = max(fits)
    assert fits == list(range(1, d_max + 1)) and d_max >= 64
    big = torch.zeros((9, 1, 70, d_max + 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        tka.jet_attention_scores_cuda(big, big, 0.1)


def test_wrapper_refuses_a_geometry_the_kernel_does_not_take(monkeypatch):
    """A geometry with more warps than the f64 N1 = 9 kernel's 256-thread
    launch bound is refused before the launch, naming the limit."""
    monkeypatch.setattr(tka, "check_cuda_tensor", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "launch", lambda *a: pytest.fail("launched"))
    q = torch.zeros((9, 1, 64, 8), dtype=torch.float64)
    geo = tka.scores_geometry(9, 64, 8, torch.float64, 1)
    monkeypatch.setattr(tka, "scores_geometry",
                        lambda *a: geo._replace(groups=4, split=4))
    with pytest.raises(ValueError, match="at most 8 warps"):
        tka.jet_attention_scores_cuda(q, q, 0.1)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated in plain torch
# ---------------------------------------------------------------------------

_LOWEST = -1.7976931348623157e308


def _exp_jet(s, shift):
    """e-jet of exp(s - shift) by the power-series recurrence, as the kernel
    runs it (m s_m, then the sum times 1/m)."""
    e = [torch.exp(s[0] - shift)]
    for m in range(1, len(s)):
        e.append(sum(j * s[j] * e[m - j] for j in range(1, m + 1)) * (1.0 / m))
    return e


def _merge(run_a, tot_a, run_b, tot_b):
    mx = torch.maximum(run_a, run_b)
    a, b = torch.exp(run_a - mx), torch.exp(run_b - mx)
    return mx, [ta * a + tb * b for ta, tb in zip(tot_a, tot_b)]


def _kernel_emulation(q, k, scale, split, tiles):
    """K5's arithmetic for one geometry: per (query, key slice, lane) an
    online max and e-jet totals over the lane's two keys of each 8-key tile
    (tiles walked stage by stage), the lanes merged in the butterfly order
    (xor 1, then 2), the slices merged with the common max, then the e-jet
    with the final max and p over it in place: p_0 = e_0 / tot_0,
    p_m = (e_m - sum_j tot_j p_{m-j}) / tot_0."""
    n1, b, t, d = q.shape
    qs = q * scale
    s = [sum(torch.einsum("bqd,bkd->bqk", qs[i], k[m - i]) for i in range(m + 1))
         for m in range(n1)]
    ktb = split * tiles * 8
    shape = (b, t, split, 4)
    run = torch.full(shape, _LOWEST, dtype=q.dtype)
    tot = [torch.zeros(shape, dtype=q.dtype) for _ in range(n1)]
    lanes = torch.arange(4)
    for st in range(-(-t // ktb)):
        for nt in range(tiles):
            key0 = st * ktb + (torch.arange(split) * tiles + nt) * 8           # (split,)
            keys = key0[:, None, None] + 2 * lanes[None, :, None] + torch.arange(2)
            valid = keys < t                                                   # (split, 4, 2)
            kk = keys.clamp(max=t - 1)
            sk = [sm[:, :, kk] for sm in s]                                    # (b, t, split, 4, 2)
            s0 = torch.where(valid, sk[0], torch.full_like(sk[0], _LOWEST))
            tm = s0.amax(-1)
            up = tm > run
            alpha = torch.where(up, torch.exp(run - tm), torch.ones_like(run))
            tot = [tm_ * alpha for tm_ in tot]
            run = torch.where(up, tm, run)
            e = _exp_jet(sk, run[..., None])
            tot = [tm_ + torch.where(valid, em, torch.zeros_like(em)).sum(-1)
                   for tm_, em in zip(tot, e)]
    for off in (1, 2):
        other = lanes ^ off
        run, tot = _merge(run, tot, run[..., other], [tm_[..., other] for tm_ in tot])
    run, tot = run[..., 0], [tm_[..., 0] for tm_ in tot]                       # (b, t, split)
    mx = run.amax(-1)
    a = torch.exp(run - mx[..., None])
    tot = [(a * tm_).sum(-1) for tm_ in tot]
    inv0 = 1.0 / tot[0]
    e = _exp_jet(s, mx[..., None])
    p = [e[0] * inv0[..., None]]
    for m in range(1, n1):
        r = e[m] - sum(tot[j][..., None] * p[m - j] for j in range(1, m + 1))
        p.append(r * inv0[..., None])
    return torch.stack(p)


@pytest.mark.parametrize("split,tiles", [(1, 1), (2, 1), (4, 2), (8, 4), (3, 5)])
@pytest.mark.parametrize("t", [1, 2, 9, 33, 70])
@pytest.mark.parametrize("order", [2, 8])
def test_kernel_arithmetic_matches_the_plain_version(order, t, split, tiles):
    """The emulated tiling and merges reproduce the plain version to 1e-12
    (f64) for several tile widths and key splits, ragged T included."""
    q, k = _qk(order * 31 + t + split, order, (2, t, 5))
    qt, kt = torch.tensor(q), torch.tensor(k)
    got = _kernel_emulation(qt, kt, 0.45, split, tiles)
    _close(got, tref.jet_attention_scores_ref(qt, kt, 0.45), 1e-12)


def test_kernel_arithmetic_is_exact_on_one_key():
    """At T = 1 the totals are the key's own e-jet, so p = (1, 0, ..., 0)
    exactly, as in the plain version (whose orders above 0 the gate holds
    against a maximum of 0)."""
    q, k = _qk(5, 8, (3, 1, 4))
    got = _kernel_emulation(torch.tensor(q), torch.tensor(k), 0.5, 1, 1)
    want = tref.jet_attention_scores_ref(torch.tensor(q), torch.tensor(k), 0.5)
    assert torch.equal(got[0], torch.ones_like(got[0]))
    assert torch.equal(got[1:], torch.zeros_like(got[1:]))
    assert torch.equal(want[1:], torch.zeros_like(want[1:]))


# ---------------------------------------------------------------------------
# the run-time-order kernel's tiling (jet_attention.scores_runtime_geometry:
# orders past the templates and bfloat16), checked without a card
# ---------------------------------------------------------------------------

RT_DTYPES = [torch.float64, torch.float32, torch.bfloat16]
RT_SHAPES = [(4, 1024, 8), (4, 256, 8), (2, 70, 16), (3, 33, 64), (3, 31, 1), (5, 3, 4),
             (2, 1, 8), (1, 70, 64), (19, 2, 8), (2, 9, 3)]


def _rt_bytes(n1, d, groups, split, tiles, ring, item_s, item_t):
    """The tiled block's shared memory, written out: the query and key
    fragments as the templates keep them, the keys in the storage type
    (``item_s`` bytes), the rest in the compute type (``item_t``); per warp
    two jets of two pairs a lane, the lane's totals and its running max;
    per group 8 queries' totals and maxima; 1/m."""
    frag = n1 * -(-d // 4) * 32
    per_warp = 2 * (2 * n1 * 32) + n1 * 32 + 32
    return (item_t * (groups * frag + groups * split * per_warp + groups * (n1 * 8 + 8) + n1)
            + item_s * ring * split * tiles * frag)


def _old_rt_admits(n1, d, item):
    """What the run-time K5 admitted before its tiled kernel: one warp of
    n1 (D + 65) words."""
    return n1 * (d + 65) * item <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", RT_DTYPES, ids=["f64", "f32", "bf16"])
@pytest.mark.parametrize("n1", [10, 11, 17])
@pytest.mark.parametrize("shape", RT_SHAPES, ids=["x".join(map(str, s)) for s in RT_SHAPES])
def test_runtime_scores_geometry_fits_and_covers_every_key_once(shape, n1, dtype):
    """The run-time block fits the 232,448 bytes at the size its formula
    gives, with at most 8 warps, the whole row in one stage only where one
    stage holds it; its blocks, warps, stages and tiles visit every (query,
    key) pair of a row exactly once."""
    b, t, d = shape
    geo = tka.scores_runtime_geometry(n1, t, d, dtype, b)
    item_s = torch.empty((), dtype=dtype).element_size()
    assert not geo.smallest
    assert geo.smem == _rt_bytes(n1, d, *geo[:4], item_s, max(item_s, 4)) <= SMEM_LIMIT
    assert 1 <= geo.groups * geo.split <= 8 and geo.ring in (1, 2)
    if geo.whole:
        assert geo.split * geo.tiles * 8 >= t
    np.testing.assert_array_equal(_visits(t, geo), 1)


def test_scores_rt_smem_bytes_is_the_kernels_formula():
    """scores_rt_smem_bytes against csrc/jet_runtime.cu::scores_tiled_bytes,
    evaluated from its source, and against the layout written out here;
    the launcher takes rings of 1 and 2 stages, the warps of a K3-K5
    block."""
    import re
    src = (cuda_lib.CSRC / "jet_runtime.cu").read_text()
    m = re.search(r"int64_t scores_tiled_bytes\(int n1, int nch, int groups, int split,\s*"
                  r"int tiles, int ring, int item_s,\s*int item_t\) \{\s*return (.*?);\s*\}",
                  src, re.S)
    assert m, "scores_tiled_bytes not found"
    expr = " ".join(m.group(1).replace("static_cast<int64_t>", "").split())
    for n1, d, groups, split, tiles, ring, item_s, item_t in [
            (10, 1, 1, 1, 1, 1, 4, 4), (11, 8, 4, 2, 4, 2, 8, 8), (17, 70, 2, 4, 3, 2, 2, 4),
            (13, 13, 1, 8, 2, 2, 8, 8), (11, 8, 4, 2, 32, 1, 8, 8), (398, 5, 1, 2, 7, 1, 2, 4)]:
        env = dict(n1=n1, nch=-(-d // 4), groups=groups, split=split, tiles=tiles,
                   ring=ring, item_s=item_s, item_t=item_t)
        got = tka.scores_rt_smem_bytes(n1, d, groups, split, tiles, ring, item_s, item_t)
        assert got == eval(expr, env) == _rt_bytes(n1, d, groups, split, tiles, ring,
                                                   item_s, item_t)
    assert re.search(r"constexpr int kScoresMaxRing = (\d+);", src).group(1) == "2"
    assert re.search(r"constexpr int kMaxWarps = (\d+);", src).group(1) == str(tka._RT_WARPS)


@pytest.mark.parametrize("dtype", RT_DTYPES, ids=["f64", "f32", "bf16"])
def test_runtime_scores_admits_what_it_admitted_before(dtype):
    """No shape the run-time K5's one-warp block admitted is refused now,
    and nothing it refused is admitted: orders from 10 to past the largest
    the old block took at D 8 (n1 398 at f64), head dims 1 to 2577, T 1 to
    1024.  The smallest block (a warp a query, the old kernel) takes
    exactly what no tiled block fits."""
    item = tka.compute_itemsize(dtype)
    for d in (1, 8, 16, 64, 100, 128, 2576, 2577):
        top = SMEM_LIMIT // (item * (d + 65))
        for n1 in (10, 11, 17, 64, 200, 397, 398, 399, top, top + 1):
            for t, b in ((1, 3), (70, 2), (1024, 4)):
                geo = tka.scores_runtime_geometry(n1, t, d, dtype, b)
                assert (geo.smem <= SMEM_LIMIT) == _old_rt_admits(n1, d, item)
                item_s = torch.empty((), dtype=dtype).element_size()
                tiled = [c for c in tka._scores_runtime_tilings(t, b)
                         if tka.scores_rt_smem_bytes(n1, d, *c, item_s, item) <= SMEM_LIMIT]
                assert geo.smallest == (not tiled)
                if geo.smallest:
                    assert (geo.split, geo.smem) == tka.runtime_warps(
                        tka.scores_runtime_words(n1, d), dtype)


def test_runtime_scores_geometry_at_the_timed_shapes(monkeypatch):
    """The timed launches take the tiled kernel with the most warps an SM
    keeps: (11, 4, 1024, 8) f64 4 query groups x 2 warps, a ring of 4-tile
    stages (one block an SM, 230,488 bytes); (17, ...) 4 groups of one warp;
    the bf16 memory row 2 groups x 4 warps with the whole row in one stage
    (its keys in bfloat16); (11, 4, 256, 8) one group over 8 warps.  Order
    397 at D 8 f64 takes the smallest block, and order 398 and head dim
    2577 at order 10 are refused naming its bytes."""
    f64 = torch.float64
    assert tka.scores_runtime_geometry(11, 1024, 8, f64, 4) == (4, 2, 4, 2, 230488)
    assert tuple(tka.scores_runtime_geometry(17, 1024, 8, f64, 4))[:4] == (4, 1, 4, 2)
    assert tuple(tka.scores_runtime_geometry(3, 1024, 8, torch.bfloat16, 4))[:4] == (
        2, 4, 32, 1)
    assert tuple(tka.scores_runtime_geometry(11, 256, 8, f64, 4))[:4] == (1, 8, 1, 2)
    assert tka.scores_runtime_geometry(398, 16, 8, f64, 1) == (0, 1, 0, 0, 232432)
    monkeypatch.setattr(tka, "check_cuda_tensor", lambda *a: None)
    for shape, nbytes in (((399, 1, 16, 8), 233016), ((11, 1, 3, 2577), 232496)):
        big = torch.zeros(shape, dtype=f64)
        with pytest.raises(ValueError, match=rf"needs {nbytes} bytes of shared memory"):
            tka.jet_attention_scores_cuda(big, big, 0.5)


# the tiled run-time kernel's arithmetic, emulated in plain torch: per lane
# the online max and rescaled totals over its two keys of each tile, the
# merge over the 4 lanes and split warps of a query in the kernel's order,
# the e-jet and division recurrences kScoresTile orders at a time (the
# earlier orders from a sliding window, the window's own from registers)

_RT_TILE = 4   # csrc/jet_runtime.cu: kScoresTile


def _rt_exp_jet(js, shift, n1):
    """scores_exp_jet: e_0 = exp(s_0 - shift), e_m = (1/m) sum_j (j s_j)
    e_{m-j}; js[0] = s_0, js[j] = j s_j."""
    e = [torch.exp(js[0] - shift)] + [None] * (n1 - 1)
    zero = torch.zeros_like(e[0])
    lo = [None] + [js[j] if j < n1 else zero for j in range(1, _RT_TILE)]
    for m0 in range(1, n1, _RT_TILE):
        acc = [zero] * _RT_TILE
        w = [js[m0 + mm] if m0 + mm < n1 else zero for mm in range(_RT_TILE)]
        for i in range(m0):
            acc = [acc[mm] + e[i] * w[mm] for mm in range(_RT_TILE)]
            w = [js[m0 - i - 1] if i + 1 < m0 else zero] + w[:-1]
        ew = []
        for mm in range(min(_RT_TILE, n1 - m0)):
            a = acc[mm]
            for ii in range(mm):
                a = a + ew[ii] * lo[mm - ii]
            ew.append(a * (1.0 / (m0 + mm)))
            e[m0 + mm] = ew[-1]
    return e


def _rt_divide(e, tot, n1):
    """scores_divide_store: p_0 = e_0 / tot_0, p_m = (e_m - sum_j tot_j
    p_{m-j}) / tot_0, over the same windows."""
    inv0 = 1.0 / tot[0]
    p = [e[0] * inv0] + [None] * (n1 - 1)
    zero = torch.zeros_like(tot[0])
    lo = [None] + [tot[j] if j < n1 else zero for j in range(1, _RT_TILE)]
    for m0 in range(1, n1, _RT_TILE):
        acc = [e[m0 + mm] if m0 + mm < n1 else zero for mm in range(_RT_TILE)]
        w = [tot[m0 + mm] if m0 + mm < n1 else zero for mm in range(_RT_TILE)]
        for i in range(m0):
            acc = [acc[mm] - w[mm] * p[i] for mm in range(_RT_TILE)]
            w = [tot[m0 - i - 1] if i + 1 < m0 else zero] + w[:-1]
        pw = []
        for mm in range(min(_RT_TILE, n1 - m0)):
            a = acc[mm]
            for ii in range(mm):
                a = a - lo[mm - ii] * pw[ii]
            pw.append(a * inv0)
            p[m0 + mm] = pw[-1]
    return p


def _rt_kernel_emulation(q, k, scale, split, tiles):
    """The tiled run-time K5 for one key split and stage width: pass 1 per
    (query, key slice, lane) over its two keys of each 8-key tile, stage by
    stage: the running max of s_0, the totals rescaled on a new max, the
    e-jet with it added (first key, then second); the merge of the split
    warps' 4 lanes of a query with their common max, in order; pass 2 the
    e-jet with the final max and p over it."""
    n1, b, t, d = q.shape
    qs = q * scale
    s = [sum(torch.einsum("bqd,bkd->bqk", qs[i], k[m - i]) for i in range(m + 1))
         for m in range(n1)]
    js = [s[0]] + [m * s[m] for m in range(1, n1)]
    ktb = split * tiles * 8
    shape = (b, t, split, 4)
    run = torch.full(shape, _LOWEST, dtype=q.dtype)
    tot = [torch.zeros(shape, dtype=q.dtype) for _ in range(n1)]
    lanes = torch.arange(4)
    for st in range(-(-t // ktb)):
        for nt in range(tiles):
            key0 = st * ktb + (torch.arange(split) * tiles + nt) * 8               # (split,)
            keys = key0[:, None, None] + 2 * lanes[None, :, None] + torch.arange(2)
            valid = keys < t                                                       # (split, 4, 2)
            kk = keys.clamp(max=t - 1)
            sk = [x[:, :, kk] for x in js]                                         # (b, t, split, 4, 2)
            tm = torch.where(valid, sk[0], torch.full_like(sk[0], _LOWEST)).amax(-1)
            up = tm > run
            alpha = torch.exp(run - tm)
            tot = [torch.where(up, x * alpha, x) for x in tot]
            run = torch.where(up, tm, run)
            e = _rt_exp_jet(sk, run[..., None], n1)
            zero = torch.zeros_like(e[0][..., 0])
            tot = [x + torch.where(valid[..., 0], em[..., 0], zero)
                   + torch.where(valid[..., 1], em[..., 1], zero) for x, em in zip(tot, e)]
    mx = run.amax((-2, -1))                                                        # (b, t)
    merged = []
    for x in tot:
        acc = torch.zeros_like(mx)
        for sl in range(split):
            for j in range(4):
                acc = acc + torch.exp(run[..., sl, j] - mx) * x[..., sl, j]
        merged.append(acc[..., None])
    e = _rt_exp_jet(js, mx[..., None], n1)
    return torch.stack(_rt_divide(e, merged, n1))


@pytest.mark.parametrize("split,tiles", [(1, 1), (4, 2)])
@pytest.mark.parametrize("t", [9, 33, 70])
@pytest.mark.parametrize("order", [10, 12, 16])
def test_runtime_kernel_arithmetic_matches_the_plain_version(order, t, split, tiles):
    """The emulated run-time tiling, merges and windowed recurrences
    reproduce the plain version to 1e-12 (f64) at orders 10, 12 and 16, for
    one and several key slices, ragged T included."""
    q, k = _qk(order * 17 + t + split, order, (2, t, 5))
    qt, kt = torch.tensor(q), torch.tensor(k)
    got = _rt_kernel_emulation(qt, kt, 0.45, split, tiles)
    _close(got, tref.jet_attention_scores_ref(qt, kt, 0.45), 1e-12)


@pytest.mark.parametrize("order", [10, 16])
def test_runtime_kernel_arithmetic_is_exact_on_one_key(order):
    """At T = 1 the merged totals are the key's own e-jet and pass 2
    recomputes it bit for bit, so p = (1, 0, ..., 0) exactly."""
    q, k = _qk(5 + order, order, (3, 1, 4))
    got = _rt_kernel_emulation(torch.tensor(q), torch.tensor(k), 0.5, 1, 1)
    assert torch.equal(got[0], torch.ones_like(got[0]))
    assert torch.equal(got[1:], torch.zeros_like(got[1:]))
