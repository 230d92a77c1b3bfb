"""K5, the materializing attention-score jet, against the JAX package: the
plain version (``ref.jet_attention_scores_ref``) and the public op
(``ops.jet_attention_scores``) against the reference's straight-line
oracle, its Pallas kernel in interpret mode and the jet algebra
(softmax of the scaled Cauchy einsum); batch-axis folding, the backward
against ``jax.vjp``, the row-sum invariant, the launch counter and
registry entry, and what the dispatch hands the CUDA launcher.

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
    assert args[3:] == (6, t, d, n1, 1, 0.25)
    assert tops.launch_counts()["jet_attention_scores"] == 1


def test_wrapper_refuses_what_the_kernel_does_not_take():
    cpu = torch.zeros((2, 1, 3, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tka.jet_attention_scores_cuda(cpu, cpu, 0.5)
    # orders 0..8, the kernels' template limit, bind on the CPU as well
    big = torch.zeros((10, 1, 3, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="0..8"):
        tops.jet_attention_scores(big, big, 0.5)
    # the key tile (32 rows padded to D + 1) and 8 query jets, 9 coefficients
    assert tka.scores_smem_bytes(9, 16, torch.float64) == 9 * (32 * 17 + 8 * 16) * 8
