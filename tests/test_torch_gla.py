"""The port's chunked gated linear attention (``repro_torch.models.gla``)
against the JAX package's, at float64 with both packages' float32 islands
lifted (``tests/_torch_lm.py``), within the LM harness's 1e-11 of each
tensor's max: both decay layouts (a scalar per head, Mamba2's; a vector per
channel, RWKV-6's), both modes (mamba includes the current token; rwkv
shifts the decay and adds the ``u`` bonus, or not), one chunk and several,
from zeros or from a carried state; the step-wise recurrence against the
chunked one; the bfloat16 pairwise path; the gradient through the chunks
recomputed in the backward, at a decay so steep that an exponential taken
before its mask overflows; and the refusal of a chunk that does not divide
the sequence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_lm as H
from repro.models import gla as jgla
from repro_torch.models import gla

B, S, NH, DK, DV = 2, 32, 2, 8, 4
TOL = H.TOL["float64"]
PAIR_BF16_TOL = 2e-2      # of the output's max: exp(diff), q and k rounded to bfloat16


def inputs(scalar: bool, state: bool, seed: int = 0, steep: float = 1.0):
    """q, k, v, log decay (in (-steep, 0) a step), u and a carried state,
    float64 numpy."""
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(B, S, NH, DK)) for _ in range(2))
    v = rng.normal(size=(B, S, NH, DV))
    ld = -steep * rng.uniform(0.05, 1.0, size=(B, S, NH, 1 if scalar else DK))
    u = rng.normal(size=(NH, DK))
    s0 = rng.normal(size=(B, NH, DK, DV)) if state else None
    return q, k, v, ld, u, s0


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = [(scalar, mode, use_u, chunk, state)
         for scalar in (True, False) for mode in ("mamba", "rwkv")
         for use_u in ((False, True) if mode == "rwkv" else (False,))
         for chunk in (S, 8) for state in (False, True)]


def _id(case):
    scalar, mode, use_u, chunk, state = case
    return (f"{'scalar' if scalar else 'vector'}-{mode}{'-u' if use_u else ''}-chunk{chunk}"
            f"{'-state' if state else ''}")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_chunked_gla_matches_reference(case):
    scalar, mode, use_u, chunk, state = case
    q, k, v, ld, u, s0 = inputs(scalar, state)
    u = u if use_u else None
    with H.islands("float64"):
        want_y, want_s = jgla.chunked_gla(*map(_j, (q, k, v, ld)), u=_j(u), mode=mode,
                                          chunk=chunk, state=_j(s0))
        got_y, got_s = gla.chunked_gla(*map(_t, (q, k, v, ld)), u=_t(u), mode=mode,
                                       chunk=chunk, state=_t(s0))
    assert got_y.dtype == got_s.dtype == torch.float64
    H.close(got_y, want_y, TOL, "y")
    H.close(got_s, want_s, TOL, "state")


@pytest.mark.parametrize("scalar", [True, False], ids=["scalar", "vector"])
@pytest.mark.parametrize("mode", ["mamba", "rwkv"])
def test_decode_steps_are_the_chunked_recurrence(scalar, mode):
    """``gla_decode_step`` S times from the carried state gives the chunked
    readouts at every position and its final state; and each step equals
    the reference's."""
    q, k, v, ld, u, s0 = inputs(scalar, True, seed=1)
    u = u if mode == "rwkv" else None
    with H.islands("float64"):
        want_y, want_s = gla.chunked_gla(*map(_t, (q, k, v, ld)), u=_t(u), mode=mode,
                                         chunk=8, state=_t(s0))
        st, jst, ys = _t(s0), _j(s0), []
        for t in range(S):
            step = [a[:, t] for a in (q, k, v, ld)]
            y, st = gla.gla_decode_step(*map(_t, step), st, u=_t(u), mode=mode)
            jy, jst = jgla.gla_decode_step(*map(_j, step), jst, u=_j(u), mode=mode)
            H.close(y, jy, TOL, f"step {t} vs reference")
            ys.append(y)
    H.close(torch.stack(ys, 1), want_y, TOL, "readouts")
    H.close(st, want_s, TOL, "state")
    H.close(st, jst, TOL, "state vs reference")


def test_pair_bf16_within_bfloat16_of_the_float32_path():
    """RWKV-6's pairwise tensors in bfloat16 (float32 inputs): within
    PAIR_BF16_TOL of the float32 path, and of the reference's bfloat16
    path."""
    q, k, v, ld, u, _ = (None if a is None else a.astype(np.float32)
                         for a in inputs(False, False, seed=2))
    args = dict(u=u, mode="rwkv", chunk=8)
    exact, _ = gla.chunked_gla(*map(_t, (q, k, v, ld)), **{**args, "u": _t(u)})
    got, _ = gla.chunked_gla(*map(_t, (q, k, v, ld)), **{**args, "u": _t(u)}, pair_bf16=True)
    want, _ = jgla.chunked_gla(*map(_j, (q, k, v, ld)), **{**args, "u": _j(u)}, pair_bf16=True)
    assert got.dtype == torch.float32
    H.close(got, exact, PAIR_BF16_TOL, "bf16 pairs vs f32")
    H.close(got, want, PAIR_BF16_TOL, "bf16 pairs vs reference")
    assert H.rel(got, exact) > 0          # the bfloat16 path was taken


# per precision: the steepest log decay a step, and where exp overflows
STEEP = {"float64": 120.0, "float32": 30.0}     # exp overflows past 709.8 / 88.7


def _grads(scalar, mode, dtype, islands):
    """(port, reference) gradients of a weighted sum of the readouts and
    the final state with respect to every input, ``dtype`` inputs."""
    q, k, v, ld, u, s0 = inputs(scalar, True, seed=3, steep=STEEP[dtype])
    u = u if mode == "rwkv" else None
    rng = np.random.default_rng(4)
    wy, ws = rng.normal(size=(B, S, NH, DV)), rng.normal(size=(B, NH, DK, DV))
    arrays = [a.astype(dtype) for a in (q, k, v, ld, s0) + ((u,) if u is not None else ())]

    def jloss(q, k, v, ld, s0, *u_):
        y, s = jgla.chunked_gla(q, k, v, ld, u=u_[0] if u_ else None, mode=mode, chunk=8,
                                state=s0)
        return jnp.sum(y * wy.astype(dtype)) + jnp.sum(s * ws.astype(dtype))

    with H.islands(islands):
        want = jax.grad(jloss, argnums=tuple(range(len(arrays))))(*map(_j, arrays))
        ts = [_t(a).requires_grad_() for a in arrays]
        y, s = gla.chunked_gla(*ts[:4], u=ts[5] if u is not None else None, mode=mode,
                               chunk=8, state=ts[4])
        loss = torch.sum(y * _t(wy.astype(dtype))) + torch.sum(s * _t(ws.astype(dtype)))
        got = torch.autograd.grad(loss, ts)
    return got, want


GRAD_NAMES = ("q", "k", "v", "log_decay", "state", "u")


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("scalar", [True, False], ids=["scalar", "vector"])
@pytest.mark.parametrize("mode", ["mamba", "rwkv"])
def test_gradient_through_recomputed_chunks_matches_reference(scalar, mode, precision):
    """The gradient through chunks recomputed in the backward against
    ``jax.grad`` of the reference, every input's, finite.  The log decays
    reach STEEP a step, so within a chunk of 8 the differences above the
    diagonal pass the point where exp overflows: an exponential taken
    before its mask would put a NaN into the gradient.  At float64 (islands
    lifted in both packages) within 1e-11; at float32 (islands in place)
    under the harness's float32 rule: as close to the lifted float64
    reference as 4x the reference's own float32 gradient, or 1e-5."""
    got, want = _grads(scalar, mode, precision, precision)
    if precision == "float32":
        want64 = _grads(scalar, mode, "float64", "float64")[1]
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert bool(torch.isfinite(g).all()), name
        if precision == "float64":
            H.close(g, w, TOL, f"grad {name}")
    if precision == "float32":
        for name, g, w, w64 in zip(GRAD_NAMES, got, want, want64):
            H.close(g, w64, max(H.TOL["float32"], 4 * H.rel(w, w64)), f"grad {name}")


def test_chunk_must_divide_the_sequence():
    q, k, v, ld, _, _ = inputs(True, False)
    with pytest.raises(ValueError, match="does not divide"):
        gla.chunked_gla(*map(_t, (q, k, v, ld)), chunk=12)
    # a chunk longer than the sequence is the whole sequence, as in the reference
    y, _ = gla.chunked_gla(*map(_t, (q, k, v, ld)), chunk=4 * S)
    assert y.shape == (B, S, NH, DV)
