"""Binding logical parameter / input / state specs to a torch device mesh,
plus the step builders the trainer, the server and the production planner
use.

A bound spec becomes DTensor placements on the mesh
(``models.sharding_rules.placements``); ``distribute_params`` places a
tree of tensors by a tree of :class:`Sharding`
(the reference's ``in_shardings``), and the collectives GSPMD would insert
are those DTensor's propagation inserts.

FSDP: for archs past the threshold, every large parameter additionally
shards its largest still-replicated (and divisible) dimension over the data
axis; DTensor all-gathers it at use and reduce-scatters its gradient.

The binders read only the mesh's axis names and sizes (``axis_sizes``), so
they plan the production meshes from a ``{name: size}`` mapping without
their ranks.

Differences from the JAX package's module:

* ``BuiltStep.fn`` is an eager callable over DTensors (plain tensors it is
  given are distributed by its shardings on entry), not a jitted function;
  ``arg_specs`` holds ``meta`` tensors in place of ``ShapeDtypeStruct``.
* ``jax.jit``'s donated buffers (``donate_argnums``) have no counterpart:
  a step returns new trees and the caller drops the old ones, so the
  parameters and the optimizer state are held twice for the moment of the
  update.
* The model runs under ``implicit_replication``: a plain tensor made inside
  it (positions, masks, constants) meets a DTensor as a replicated one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MODEL_AXIS, ArchConfig, ShapeCfg
from repro_torch.models import transformer as tfm
from repro_torch.models.sharding_rules import (Rules, Spec, axis_sizes, bind_pspec,
                                               make_rules, placements, shard, spec_map,
                                               use_rules)
from repro_torch.optim import AdamState, adam_init, adam_update
from repro_torch.tree import leaves, tree_map, unflatten

FSDP_PARAM_THRESHOLD = 20_000_000_000  # params; gemma2-27b and llama4 qualify
FSDP_LEAF_MIN = 1 << 22                # don't FSDP tiny leaves
DEFAULT_ACCUM_ABOVE = 100_000_000_000  # grad-accum for >100B-param models


def arch_param_count(cfg: ArchConfig) -> int:
    return sum(leaf.numel() for leaf in leaves(tfm.init_model(cfg, abstract=True)))


def wants_fsdp(cfg: ArchConfig) -> bool:
    return arch_param_count(cfg) >= FSDP_PARAM_THRESHOLD


def fsdp_extend(spec: Spec, shape, rules: Rules, axis_size: int) -> Spec:
    """Add an "fsdp" entry on the largest unsharded, divisible dim."""
    if not rules.fsdp:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for i, (e, n) in enumerate(zip(entries, shape)):
        if e is None and n % axis_size == 0 and n > best_size:
            best, best_size = i, n
    if best is None:
        return spec
    entries[best] = "fsdp"
    return Spec(*entries)


def sanitize_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop sharding entries whose dimension doesn't divide the axis size,
    as the reference must for ``in_shardings`` (granite's 49155 vocab,
    rwkv6's 40 heads); DTensor could shard them unevenly, but the layout
    stays the reference's."""
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        if e is None:
            out.append(None)
            continue
        axes = e if isinstance(e, tuple) else (e,)
        size = math.prod(sizes.get(a, 1) for a in axes)
        out.append(e if size > 0 and dim % size == 0 else None)
    return Spec(*out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a leaf lives: a bound ``spec`` on ``mesh`` (a ``DeviceMesh``,
    or a ``{name: size}`` mapping when planning).  Unpacks as ``(mesh,
    placements)``."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def __iter__(self):
        return iter((self.mesh, self.placements))

    def local_shape(self, shape) -> Tuple[int, ...]:
        """The largest per-rank shard of a leaf of ``shape``."""
        sizes = axis_sizes(self.mesh)
        out = list(shape)
        for d, e in enumerate(self.spec):
            if e is not None:
                n = math.prod(sizes[a] for a in (e if isinstance(e, tuple) else (e,)))
                out[d] = -(-out[d] // n)
        return tuple(out)


def zip_map(fn, tree, other):
    """``fn(leaf, other_leaf)`` over a tree of tensors and a tree of the
    same structure whose leaves may be any object (``Sharding``)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, other)
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [zip_map(fn, v, o) for v, o in zip(tree, other)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def place(t: torch.Tensor, s: Sharding):
    """``t`` as a DTensor laid out by ``s``: distributed from rank 0's data
    when plain, redistributed when a DTensor laid out otherwise."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    target = s.placements
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == target else t.redistribute(s.mesh, target)
    return distribute_tensor(t, s.mesh, target)


def distribute_params(tree, shardings):
    """Every leaf of ``tree`` (parameters, moments, a batch, a decode
    state) placed by the matching ``Sharding``."""
    return zip_map(place, tree, shardings)


def bind_param_specs(mesh, pspecs, abstract_params, rules: Rules):
    """The bound, sanitized spec of every parameter leaf (FSDP-extended on
    leaves of FSDP_LEAF_MIN elements or more when ``rules.fsdp``)."""
    axis_size = axis_sizes(mesh).get("data", 1)

    def bind(spec, leaf):
        if rules.fsdp and leaf.numel() >= FSDP_LEAF_MIN:
            spec = fsdp_extend(spec, leaf.shape, rules, axis_size)
        return sanitize_spec(bind_pspec(spec, rules), leaf.shape, mesh)

    return spec_map(bind, pspecs, abstract_params)


def bind_param_shardings(mesh, pspecs, abstract_params, rules: Rules):
    """A tree of :class:`Sharding`, one per parameter leaf."""
    return spec_map(lambda s: Sharding(mesh, s),
                    bind_param_specs(mesh, pspecs, abstract_params, rules))


# ---------------------------------------------------------------------------
# input / state specs
# ---------------------------------------------------------------------------

def batch_pspec(rules: Rules, ndim: int) -> Spec:
    return Spec(*((rules.resolve("batch"),) + (None,) * (ndim - 1)))


def input_shardings(mesh, cfg: ArchConfig, shape: ShapeCfg, rules: Rules):
    return {k: Sharding(mesh, batch_pspec(rules, v.ndim))
            for k, v in abstract_inputs(cfg, shape).items()}


def abstract_inputs(cfg: ArchConfig, shape: ShapeCfg) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of this shape (tokens
    int32, as the reference's; the model takes any integer tokens)."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    if shape.kind == "decode":
        return {"token": torch.empty((b, 1), dtype=torch.int32, device=meta)}
    out = {"tokens": torch.empty((b, s - (cfg.vlm_image_tokens or 0)), dtype=torch.int32,
                                 device=meta)}
    dt = tfm.model_dtype(cfg)
    if cfg.encoder is not None:
        out["frames"] = torch.empty((b, cfg.encoder.seq, cfg.d_model), dtype=dt, device=meta)
    if cfg.vlm_image_tokens:
        out["image_embeds"] = torch.empty((b, cfg.vlm_image_tokens, tfm.VLM_EMBED_DIM),
                                          dtype=dt, device=meta)
    return out


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def state_pspecs(cfg: ArchConfig, shape: ShapeCfg, rules: Rules, mesh) -> Dict[str, Any]:
    """Decode-state sharding: batch over (pod, data) when it divides, else
    sequence-parallel KV (long_500k: B=1 -> shard the 512k cache over data);
    heads/head_dim over model when divisible."""
    sizes = axis_sizes(mesh)
    st = tfm.decode_state_specs(cfg, shape.global_batch, shape.seq_len, abstract=True)
    batch_ax = rules.resolve("batch")
    n_batch = math.prod(sizes[a] for a in rules.batch)
    b_entry = batch_ax if _div(shape.global_batch, n_batch) and n_batch > 1 else None
    seq_entry = rules.batch[-1] if (b_entry is None and rules.batch) else None

    def kv_spec(leaf):  # (L, B, S, kvh, hd)
        _, _, s, kvh, hd = leaf.shape
        head_entry = "model" if _div(kvh, MODEL_AXIS) else None
        hd_entry = "model" if (head_entry is None and _div(hd, MODEL_AXIS)) else None
        return Spec(None, b_entry, seq_entry if _div(s, sizes.get("data", 1)) else None,
                    head_entry, hd_entry)

    out: Dict[str, Any] = {"pos": Spec()}
    for key in ("kv", "shared_kv", "cross_kv"):
        if key in st:
            out[key] = type(st[key])(*(kv_spec(leaf) for leaf in st[key]))
    if "mamba" in st:
        ssm, conv = st["mamba"]
        h = ssm.shape[2]
        out["mamba"] = type(st["mamba"])(
            Spec(None, b_entry, "model" if _div(h, MODEL_AXIS) else None, None, None),
            Spec(None, b_entry, None, "model" if _div(conv.shape[-1], MODEL_AXIS) else None))
    if "rwkv" in st:
        wkv, s1, _ = st["rwkv"]
        h, hd = wkv.shape[2], wkv.shape[3]
        wkv_spec = Spec(None, b_entry, "model" if _div(h, MODEL_AXIS) else None,
                        None if _div(h, MODEL_AXIS) else ("model" if _div(hd, MODEL_AXIS) else None),
                        None)
        d_spec = Spec(None, b_entry, None, "model" if _div(s1.shape[-1], MODEL_AXIS) else None)
        out["rwkv"] = type(st["rwkv"])(wkv_spec, d_spec, d_spec)
    return out


def state_shardings(mesh, cfg: ArchConfig, shape: ShapeCfg, rules: Rules):
    st_abs = tfm.decode_state_specs(cfg, shape.global_batch, shape.seq_len, abstract=True)
    return spec_map(lambda s, leaf: Sharding(mesh, sanitize_spec(bind_pspec(s, rules),
                                                                 leaf.shape, mesh)),
                    state_pspecs(cfg, shape, rules, mesh), st_abs)


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BuiltStep:
    fn: Any                   # eager callable over DTensors
    arg_specs: Tuple          # meta-tensor stand-ins of its arguments
    rules: Rules
    param_shardings: Any
    opt_state_dtype: Optional[str] = None
    arg_shardings: Tuple = ()  # a Sharding per leaf of ``arg_specs``


def _replicated(t):
    """A DTensor reduced to Replicate on every mesh dim (a Partial loss
    would otherwise seed its backward with ones on every rank)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, (Replicate(),) * t.device_mesh.ndim)


def _model_context(rules: Rules):
    from contextlib import ExitStack

    from torch.distributed.tensor.experimental import implicit_replication
    stack = ExitStack()
    stack.enter_context(use_rules(rules))
    stack.enter_context(implicit_replication())
    return stack


def build_train_step(cfg: ArchConfig, mesh, shape: ShapeCfg, *,
                     knobs: tfm.Knobs = tfm.Knobs(),
                     fsdp: Optional[bool] = None,
                     lr: float = 3e-4,
                     accum: Optional[int] = None,
                     policy: str = "tp",
                     opt_state_dtype: Optional[str] = None) -> BuiltStep:
    """``fn(params, opt_state, batch) -> (params, opt_state, loss,
    metrics)``: ``train_loss`` under autograd with the rules active,
    averaged over ``accum`` microbatches (halved until it divides the
    batch), then ``adam_update(..., grad_clip=1.0)``; parameters and
    moments laid out by ``param_shardings``."""
    fsdp = wants_fsdp(cfg) if fsdp is None else fsdp
    if accum is None:
        accum = 4 if arch_param_count(cfg) >= DEFAULT_ACCUM_ABOVE else 1
    while shape.global_batch % accum:
        accum //= 2
    rules = make_rules(mesh, fsdp=fsdp, policy=policy)
    abstract_params = tfm.init_model(cfg, abstract=True)
    p_shard = bind_param_shardings(mesh, tfm.param_specs(cfg), abstract_params, rules)
    state_dtype = None if opt_state_dtype is None else tfm.DTYPES[opt_state_dtype]
    opt_abs = adam_init(abstract_params, state_dtype)
    in_batch = input_shardings(mesh, cfg, shape, rules)

    def grad_fn(params, batch):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        loss, metrics = tfm.train_loss(unflatten(params, flat), cfg, batch, knobs)
        loss = _replicated(loss)
        grads = unflatten(params, list(torch.autograd.grad(loss, flat)))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                distribute_params(grads, p_shard))

    def train_step(params, opt_state, batch):
        params = distribute_params(params, p_shard)
        opt_state = AdamState(opt_state.step, distribute_params(opt_state.m, p_shard),
                              distribute_params(opt_state.v, p_shard))
        batch = {k: place(v, in_batch[k]) for k, v in batch.items()}
        with _model_context(rules):
            if accum == 1:
                loss, metrics, grads = grad_fn(params, batch)
            else:
                # the reference's float32 zeros plus the first microbatch,
                # exactly: its gradients widened to at least float32
                n = shape.global_batch // accum
                for i in range(accum):
                    mb = {k: shard(v[i * n:(i + 1) * n], "batch", *([None] * (v.ndim - 1)))
                          for k, v in batch.items()}
                    loss_i, metrics, g = grad_fn(params, mb)
                    if i == 0:
                        gsum = tree_map(lambda g: g.to(torch.promote_types(g.dtype, torch.float32)), g)
                        lsum = loss_i
                    else:
                        gsum = tree_map(torch.add, gsum, g)
                        lsum = lsum + loss_i
                grads = tree_map(lambda g: g / accum, gsum)
                loss = lsum / accum
            new_params, new_opt = adam_update(grads, opt_state, params, lr, grad_clip=1.0)
        return new_params, new_opt, loss, metrics

    args = (abstract_params, opt_abs, abstract_inputs(cfg, shape))
    opt_shard = AdamState(Sharding(mesh, Spec()), p_shard, p_shard)
    return BuiltStep(train_step, args, rules, p_shard, opt_state_dtype,
                     (p_shard, opt_shard, in_batch))


def build_prefill_step(cfg: ArchConfig, mesh, shape: ShapeCfg, *,
                       knobs: tfm.Knobs = tfm.Knobs(),
                       fsdp: Optional[bool] = None) -> BuiltStep:
    """``fn(params, batch) -> (B, V)`` last-position logits.  Models at the
    FSDP threshold (or ``fsdp``) shard weights over data even at inference
    (TP alone leaves llama4 at ~50 GiB a rank); they are all-gathered at
    use."""
    rules = make_rules(mesh, fsdp=wants_fsdp(cfg) if fsdp is None else fsdp)
    abstract_params = tfm.init_model(cfg, abstract=True)
    p_shard = bind_param_shardings(mesh, tfm.param_specs(cfg), abstract_params, rules)
    in_batch = input_shardings(mesh, cfg, shape, rules)

    def prefill_step(params, batch):
        params = distribute_params(params, p_shard)
        batch = {k: place(v, in_batch[k]) for k, v in batch.items()}
        with _model_context(rules), torch.no_grad():
            x, _, _, _ = tfm.forward_seq(params, cfg, batch, knobs)
            return tfm.logits(params["embed"], x[:, -1:], cfg)[:, 0]

    return BuiltStep(prefill_step, (abstract_params, abstract_inputs(cfg, shape)), rules,
                     p_shard, arg_shardings=(p_shard, in_batch))


def build_serve_step(cfg: ArchConfig, mesh, shape: ShapeCfg, *,
                     knobs: tfm.Knobs = tfm.Knobs(),
                     fsdp: Optional[bool] = None) -> BuiltStep:
    """``fn(params, token, state) -> (logits, state)``: one-token decode
    against a seq_len-deep cache / state laid out by ``state_shardings``
    (sequence-parallel KV when the batch is 1; FSDP as in
    ``build_prefill_step``)."""
    sp = shape.global_batch == 1
    rules = make_rules(mesh, sp=sp, fsdp=wants_fsdp(cfg) if fsdp is None else fsdp)
    abstract_params = tfm.init_model(cfg, abstract=True)
    p_shard = bind_param_shardings(mesh, tfm.param_specs(cfg), abstract_params, rules)
    st_abs = tfm.decode_state_specs(cfg, shape.global_batch, shape.seq_len, abstract=True)
    st_shard = state_shardings(mesh, cfg, shape, rules)
    tok_shard = Sharding(mesh, batch_pspec(rules, 2) if shape.global_batch > 1
                         else Spec(None, None))

    def serve_step(params, token, state):
        params = distribute_params(params, p_shard)
        state = distribute_params(state, st_shard)
        with _model_context(rules), torch.no_grad():
            return tfm.decode_step(params, cfg, place(token, tok_shard), state)

    args = (abstract_params, abstract_inputs(cfg, shape)["token"], st_abs)
    return BuiltStep(serve_step, args, rules, p_shard,
                     arg_shardings=(p_shard, tok_shard, st_shard))


def build_step(cfg: ArchConfig, mesh, shape: ShapeCfg, **kw) -> BuiltStep:
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, **kw)
    return build_serve_step(cfg, mesh, shape, **kw)
