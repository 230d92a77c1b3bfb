"""Shared harness of ``tests/test_torch_models*.py``: the port's LM models
(``repro_torch.models``: the attention family) against the JAX package's,
at the reduced configs.  Two files share it so that neither becomes the
tail of a parallel run; each holds three archs.

The reference's ``init_model`` parameters cross over through
``repro_torch.bridge``; tokens, encoder frames and patch embeddings are made
with numpy from a seed.  Each case computes its JAX side once
(:func:`reference`, one jitted call): the final hidden states,
``train_loss`` and its gradient, ``prefill`` of S-1 tokens and one
``decode_step`` (the logits and every cache leaf).

Three modes per arch, from the same parameters (the reference draws them in
float32), tolerances relative to each compared tensor's max |ref|:

* ``float64``: both packages at float64 with their float32 islands lifted
  (see below), held within 1e-11 -- every other line of the two models
  computes the same float64 function;
* ``float64-islands`` (qwen3): the reference as it is at float64, within
  1e-6.  Not the 1e-12 of the PINN path: the reference computes float32
  islands inside a float64 model (``rms_norm``'s mean square and rsqrt, the
  RoPE frequencies and angles, the attention scores, the cross-entropy),
  and XLA and torch round those differently (``theta ** (-i / half)`` by up
  to 1 ulp, the cosines of the angles, the rsqrt of the mean square).  One
  ulp in the rsqrt island alone moves qwen3's hidden states by 5.5e-7, and
  whisper's, gemma2's and granite's by 4.0e-5, 6.8e-6 and 5.7e-6 (the port
  with its rsqrt nudged): those three would need bounds of their own, so
  the islands are held where the bound is the one stated;
* ``float32``: held to the float64 mode's reference result within 1e-5, or
  within 4x the reference's own worst float32 distance from it (over the
  tensors one test compares) where that is larger.  Float32 alone moves
  these models by up to 1.4e-5 (granite's hidden states) and their
  gradients by up to 5.7e-4 (whisper's), in both packages: the port must be
  as accurate as the reference, not equal to it.  The two packages' float32
  roundings scatter about one floor: over four batches of each of llava,
  granite and whisper, the port's worst gradient error was 0.4-3.2x the
  reference's, one leaf's up to 4.1x.

Lifting the islands: both packages name their island dtype as a module
attribute (``jnp.float32``, ``torch.float32``), so for the ``float64`` mode
their ``models`` modules see ``jnp`` / ``torch`` through a proxy that
answers float64 to ``float32``.  Nothing else changes.

The float32 and float64 modes run the blocked attention with 8-row query
and key chunks, so the local layers (window 16) take the exact-span branch
and the global ones sweep several key chunks.  The reference's blocked
global branch cannot run with its islands in place at float64 (its scan
carries a float32 accumulator that the float64 values widen), so the
``float64-islands`` mode takes chunks that do not divide S, which route
both packages through ``full_attention``.
"""

import dataclasses
from contextlib import ExitStack, contextmanager
from functools import lru_cache
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import decode_state_specs as jdecode_state_specs
from repro.models import decode_step as jdecode_step
from repro.models import forward_seq as jforward_seq
from repro.models import gla as jgla
from repro.models import init_model as jinit_model
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import prefill as jprefill
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models import train_loss as jtrain_loss
from repro.models import transformer as jtransformer
from repro.models.transformer import Knobs as JKnobs
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import (Knobs, attention, decode_state_specs, decode_step,
                                forward_seq, gla, init_model, layers, moe, prefill, rwkv,
                                ssm, train_loss, transformer)
from repro_torch.models.transformer import VLM_EMBED_DIM, stack_layers

B, S = 2, 32
PORTED = ("qwen3-0.6b", "granite-3-2b", "gemma3-4b", "gemma2-27b",
          "llava-next-mistral-7b", "whisper-large-v3", "mixtral-8x7b",
          "llama4-maverick-400b-a17b", "zamba2-2.7b", "rwkv6-3b")
RECURRENT = ("zamba2-2.7b", "rwkv6-3b")
# the decode state's stacked entries, each a NamedTuple of leaves
STATE_KEYS = ("kv", "cross_kv", "mamba", "rwkv", "shared_kv")
MODES = ("float32", "float64")
TOL = {"float64": 1e-11, "float64-islands": 1e-6, "float32": 1e-5}
# query and key chunks: see the module docstring
CHUNKS = {"float32": (8, 8), "float64": (8, 8), "float64-islands": (24, 24)}


def dtype_of(mode):
    return mode.split("-")[0]


def case_id(case):
    return f"{case[0]}-{case[1]}"


class _Wide:
    """A module proxy whose ``float32`` is float64."""

    def __init__(self, module, wide):
        self._module, self.float32 = module, wide

    def __getattr__(self, name):
        return getattr(self._module, name)


@contextmanager
def islands(mode):
    """Both packages' float32 islands lifted to float64 in the float64
    mode, left in place otherwise."""
    with ExitStack() as stack:
        if mode == "float64":
            for mod in (jlayers, jattn, jtransformer, jgla, jssm, jrwkv, jmoe):
                stack.enter_context(mock.patch.object(mod, "jnp", _Wide(jnp, jnp.float64)))
            for mod in (layers, attention, transformer, gla, ssm, rwkv, moe):
                stack.enter_context(mock.patch.object(mod, "torch",
                                                      _Wide(torch, torch.float64)))
        yield


def reference_train_steps(jcfg, jshape, params, batches, jknobs, record=None, **kw):
    """The reference's ``launch.sharding.build_train_step`` on an in-process
    (1, 1) ("data", "model") mesh, one step a batch from the port's
    ``params`` and ``batches`` (numpy-converted), float64 with every float32
    island lifted: the models', Adam's (a sharded gradient norm sums in
    another order, and float32 Adam would round that into the parameters at
    1e-9) and the microbatch loop's accumulator (a scan carry, which
    float64 gradients would otherwise widen).  Returns (losses, the final
    parameters' leaves).  With a dict ``record``, also each step's
    gradients as they reach ``adam_update`` (``record["grads"]``) and
    parameters after it (``record["params"]``), as lists of leaves."""
    from repro.launch import sharding as jsharding
    from repro.optim import adam as jadam
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    wide = _Wide(jnp, jnp.float64)
    grads = []

    def adam_update(g, *args, **kwargs):
        jax.debug.callback(lambda *leaves: grads.append([np.asarray(a) for a in leaves]),
                           *jax.tree_util.tree_leaves(g))
        return jadam.adam_update(g, *args, **kwargs)

    with islands("float64"), mock.patch.object(jadam, "jnp", wide), \
            mock.patch.object(jsharding, "jnp", wide), \
            mock.patch.object(jsharding, "adam_update", adam_update):
        built = jsharding.build_train_step(jcfg, mesh, jshape, knobs=jknobs, **kw)
        p = jax.tree_util.tree_map(jnp.asarray, bridge.params_to_numpy(params))
        o, losses, steps = jadam.adam_init(p), [], []
        for b in batches:
            p, o, loss, _ = built.fn(p, o, {"tokens": jnp.asarray(b["tokens"].numpy(),
                                                                 jnp.int32)})
            losses.append(float(loss))
            # copied: the next step donates its parameters
            steps.append([np.asarray(a) for a in jax.tree_util.tree_leaves(p)])
    if record is not None:
        record.update(grads=grads, params=steps)
    return losses, jax.tree_util.tree_leaves(p)


def lift_state(st, mode):
    """The reference's recurrent states at float64 in the float64 mode.
    Its ``init_mamba_state`` / ``init_rwkv_state`` take their float32 as a
    default argument, bound when the module was imported, which the module
    proxy cannot lift; the port reads ``torch.float32`` at call time."""
    if mode != "float64":
        return st
    return {k: (jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), v)
                if k in ("mamba", "rwkv") else v) for k, v in st.items()}


def _numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = _numpy(got), _numpy(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max()) / max(
        float(np.abs(want).max()), 1e-30)


def close(got, want, tol, what=""):
    err = rel(got, want)
    assert err <= tol, (what, err)


def cfgs(arch, mode):
    """(reference config, port config) of ``arch`` reduced, at ``mode``'s dtype."""
    return (dataclasses.replace(jget_arch(arch).reduced(), dtype=dtype_of(mode)),
            dataclasses.replace(get_arch(arch).reduced(), dtype=dtype_of(mode)))


def make_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.encoder is not None:
        out["frames"] = rng.normal(size=(B, cfg.encoder.seq, cfg.d_model)).astype(np.float32)
    if cfg.vlm_image_tokens:
        out["image_embeds"] = rng.normal(
            size=(B, cfg.vlm_image_tokens, VLM_EMBED_DIM)).astype(np.float32)
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else None) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def prefix(batch):
    pre = dict(batch)
    pre["tokens"] = batch["tokens"][:, :S - 1]
    return pre


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def state_leaves(what, state) -> dict:
    """A decode state's position and the leaves of its stacked entries by
    name (``"decode mamba.conv"``), from either package."""
    out = {f"{what} pos": state["pos"]}
    for key in STATE_KEYS:
        if key in state:
            out.update({f"{what} {key}.{f}": getattr(state[key], f)
                        for f in state[key]._fields})
    return out


def _flat(x, aux_fwd, loss, ce, aux, grads, lg_pre, st, lg_dec, st2) -> dict:
    """One case's outputs by name: hidden states, the forward's MoE aux,
    loss, ce, aux, each gradient leaf, the prefill's and the decode's logits
    and state leaves (a recurrent arch's decode: every step's logits)."""
    out = {"hidden states": x, "forward aux": aux_fwd, "loss": loss, "ce": ce, "aux": aux,
           "prefill logits": lg_pre, "decode logits": lg_dec}
    out.update({f"grad {k}": g for k, g in bridge.by_key(grads).items()})
    out.update(state_leaves("prefill", st))
    out.update(state_leaves("decode", st2))
    return {k: np.asarray(v) for k, v in out.items()}


@lru_cache(maxsize=None)
def reference(arch, mode):
    """The JAX side of one case, once: (parameters, outputs by name) as
    numpy.  An attention arch decodes one step after prefilling S-1
    tokens; a recurrent one (no cache from its prefill) decodes all S
    tokens one at a time from ``decode_state_specs`` at position 0."""
    jcfg, _ = cfgs(arch, mode)
    params, _ = jinit_model(jcfg, jax.random.PRNGKey(0))
    knobs = JKnobs(*CHUNKS[mode])
    batch = _jbatch(make_batch(jcfg))
    cap = S + jcfg.vlm_image_tokens

    def run(p, b, st0):
        x, aux_fwd = jforward_seq(p, jcfg, b, knobs)[:2]
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: jtrain_loss(q, jcfg, b, knobs), has_aux=True)(p)
        lg_pre, st = jprefill(p, jcfg, prefix(b), knobs, pad_to=cap)
        if st0 is None:
            lg_dec, st2 = jdecode_step(p, jcfg, b["tokens"][:, S - 1:], st, knobs)
        else:
            st2, lg_dec = jax.lax.scan(
                lambda s_, tok: jdecode_step(p, jcfg, tok[:, None], s_, knobs)[::-1], st0,
                b["tokens"].T)
        return (x, aux_fwd, loss, metrics["ce"], metrics["aux"], grads, lg_pre, st,
                lg_dec, st2)

    with islands(mode):
        st0 = None
        if arch in RECURRENT:
            st0 = lift_state(jdecode_state_specs(jcfg, B, S, abstract=False), mode)
            st0["pos"] = jnp.asarray(0, jnp.int32)
        out = jax.jit(run)(params, batch, st0)
    return as_numpy(params), _flat(*as_numpy(out))


def check(arch, mode, got: dict) -> None:
    """The port's outputs (by name, a subset) against the reference's in
    ``mode`` (see the module docstring for the float32 rule)."""
    _, ref = reference(arch, mode)
    tol = TOL[mode]
    if mode == "float32":
        ref32, ref = ref, reference(arch, "float64")[1]
        tol = max(tol, 4 * max(rel(ref32[n], ref[n]) for n in got if not n.endswith(" pos")))
    for name, value in got.items():
        if name.endswith(" pos"):
            assert int(value) == int(ref[name]), name
        else:
            close(value, ref[name], tol, name)


def port_params(arch, mode, requires_grad=False):
    params, _ = reference(arch, mode)
    out = bridge.params_from_numpy(params, device="cpu")
    if requires_grad:
        bridge.tree_map(lambda _, t: t.requires_grad_(), out)
    return out


# ---------------------------------------------------------------------------
# the checks each test file parametrizes over its archs
# ---------------------------------------------------------------------------

def init_builds_the_reference_tree(arch):
    """Leaf for leaf: the same keys, shapes and dtypes (bridge.leaf_keys),
    zeros where the reference has zeros, and each weight's spread within
    25% of the reference's (both draw fan-in normals)."""
    jparams, _ = reference(arch, "float32")
    _, cfg = cfgs(arch, "float32")
    mine = init_model(cfg, 0, device="cpu")
    ref = bridge.params_from_numpy(jparams, device="cpu")
    assert sorted(bridge.leaf_keys(mine)) == sorted(bridge.leaf_keys(ref))
    got, want = bridge.by_key(mine), bridge.by_key(ref)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if float(w.abs().max()) == 0:
            assert float(g.abs().max()) == 0, key
        elif g.numel() >= 256:
            assert 0.8 < float(g.std()) / float(w.std()) < 1.25, key
    # the layers the loop runs: every stacked group, then the rest
    assert sum(1 for _ in stack_layers(mine["stack"], cfg)) == cfg.n_layers


def forward_seq_matches_reference(arch, mode):
    _, cfg = cfgs(arch, mode)
    with torch.no_grad(), islands(mode):
        got, aux, n_prefix, _ = forward_seq(port_params(arch, mode), cfg,
                                            tbatch(make_batch(cfg)), Knobs(*CHUNKS[mode]))
    assert got.dtype == getattr(torch, dtype_of(mode))
    assert n_prefix == cfg.vlm_image_tokens
    check(arch, mode, {"hidden states": got, "forward aux": aux})


def train_loss_and_gradient_match_reference(arch, mode):
    _, cfg = cfgs(arch, mode)
    params = port_params(arch, mode, requires_grad=True)
    by_key = bridge.by_key(params)
    with islands(mode):
        loss, metrics = train_loss(params, cfg, tbatch(make_batch(cfg)), Knobs(*CHUNKS[mode]))
        grads = torch.autograd.grad(loss, list(by_key.values()))
    check(arch, mode, {"loss": loss, "ce": metrics["ce"], "aux": metrics["aux"],
                       **{f"grad {k}": g for k, g in zip(by_key, grads)}})


def prefill_and_decode_match_reference(arch, mode):
    """The prefill's last logits and caches (zero-padded to the capacity),
    then one decode step's logits and caches, every leaf."""
    _, cfg = cfgs(arch, mode)
    params = port_params(arch, mode)
    batch = tbatch(make_batch(cfg))
    knobs = Knobs(*CHUNKS[mode])
    with torch.no_grad(), islands(mode):
        lg_pre, st = prefill(params, cfg, prefix(batch), knobs,
                             pad_to=S + cfg.vlm_image_tokens)
        lg_dec, st2 = decode_step(params, cfg, batch["tokens"][:, S - 1:], st)
    got = {"prefill logits": lg_pre, "decode logits": lg_dec,
           **state_leaves("prefill", st), **state_leaves("decode", st2)}
    assert set(got) == {n for n in reference(arch, mode)[1]
                        if n.startswith(("prefill", "decode"))}
    check(arch, mode, got)


def stepwise_decode_matches_reference(arch, mode):
    """A recurrent arch: the prefill's last logits and position (it builds
    no state), then all S tokens decoded one at a time from
    ``decode_state_specs`` at position 0: every step's logits and, after
    the last, every leaf of the recurrent states (and zamba2's shared
    block's caches)."""
    _, cfg = cfgs(arch, mode)
    params = port_params(arch, mode)
    batch = tbatch(make_batch(cfg))
    knobs = Knobs(*CHUNKS[mode])
    with torch.no_grad(), islands(mode):
        lg_pre, st = prefill(params, cfg, prefix(batch), knobs, pad_to=S)
        st2 = decode_state_specs(cfg, B, S, device="cpu")
        st2["pos"] = torch.tensor(0)
        steps = []
        for t in range(S):
            lg, st2 = decode_step(params, cfg, batch["tokens"][:, t:t + 1], st2)
            steps.append(lg)
    assert sorted(st) == ["pos"]
    got = {"prefill logits": lg_pre, "decode logits": torch.stack(steps),
           **state_leaves("prefill", st), **state_leaves("decode", st2)}
    assert set(got) == {n for n in reference(arch, mode)[1]
                        if n.startswith(("prefill", "decode"))}
    check(arch, mode, got)


def stepwise_decode_is_the_chunked_forward(arch):
    """The port against itself, as the reference's own test (and its
    bound): decoding token by token gives the chunked forward's logits at
    every position."""
    _, cfg = cfgs(arch, "float32")
    params = port_params(arch, "float32")
    batch = tbatch(make_batch(cfg, seed=2))
    with torch.no_grad():
        want = layers.logits(params["embed"], forward_seq(params, cfg, batch)[0], cfg)
        st = decode_state_specs(cfg, B, S, device="cpu")
        st["pos"] = torch.tensor(0)
        errs = []
        for t in range(S):
            lg, st = decode_step(params, cfg, batch["tokens"][:, t:t + 1], st)
            errs.append(float((lg - want[:, t]).abs().max()))
    assert max(errs) < 5e-3, (arch, max(errs))


def prefill_then_decode_is_the_full_forward(arch):
    """The port against itself, as the reference's own test (and its
    bound): the ring cache plus one decode step give the full forward's
    last logits."""
    _, cfg = cfgs(arch, "float32")
    params = port_params(arch, "float32")
    batch = tbatch(make_batch(cfg, seed=2))
    with torch.no_grad():
        x = forward_seq(params, cfg, batch)[0]
        want = layers.logits(params["embed"], x[:, -1:], cfg)[:, 0].numpy()
        _, st = prefill(params, cfg, prefix(batch), pad_to=S + cfg.vlm_image_tokens)
        got, _ = decode_step(params, cfg, batch["tokens"][:, S - 1:], st)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-4)


def blocked_attention_matches_full_attention(arch, window, q_chunk, kv_chunk, mode):
    """The port's blocked attention against its full attention and against
    the reference's blocked and full attention, x (2, 64, d), with the
    first layer's parameters, and the recomputed chunks' gradient against
    the full attention's."""
    jcfg, cfg = cfgs(arch, mode)
    if window is not None:
        jcfg = dataclasses.replace(jcfg, window=window)
        cfg = dataclasses.replace(cfg, window=window)
    jparams, _ = reference(arch, mode)
    jlp = jax.tree_util.tree_map(lambda a: a[0], jparams["stack"]["groups"]["layers"][0]["attn"])
    lp = bridge.params_from_numpy(jlp, device="cpu")
    x = np.random.default_rng(3).normal(size=(2, 64, cfg.d_model)).astype(dtype_of(mode))
    with islands(mode):
        want_blocked, _ = jattn.blocked_attention(jlp, jcfg, jnp.asarray(x), window=window,
                                                  q_chunk=q_chunk, kv_chunk=kv_chunk)
        want_full, _ = jattn.full_attention(jlp, jcfg, jnp.asarray(x), causal=True,
                                            window=window)
        tx = torch.as_tensor(x).requires_grad_()
        got, (k, v) = attention.blocked_attention(lp, cfg, tx, window=window,
                                                  q_chunk=q_chunk, kv_chunk=kv_chunk)
        full, (fk, fv) = attention.full_attention(lp, cfg, tx, causal=True, window=window)
        g_blocked, = torch.autograd.grad(got.square().sum(), tx)
        g_full, = torch.autograd.grad(full.square().sum(), tx)
    close(got, want_blocked, TOL[mode], "blocked vs reference blocked")
    close(got, want_full, TOL[mode], "blocked vs reference full")
    close(got, full, TOL[mode], "blocked vs full")
    assert torch.equal(k, fk) and torch.equal(v, fv)
    close(g_blocked, g_full, TOL[mode], "gradient")
