"""Composable decoder/encoder stacks covering all ten LM architectures.

Layer weights are *stacked over groups*: the layer pattern (gemma3's
5 local : 1 global, llama4's dense/MoE interleave, zamba2's 6-mamba +
shared-attention period) defines a group, and a loop over the leading axis
of the stacked leaves runs the groups (the reference scans them).  Layers
that don't fill a whole group are unrolled as "rest".  With ``cfg.remat``
each group is recomputed in the backward (``torch.utils.checkpoint``), as
the reference checkpoints its scan body.

Entry points (functional; params are plain dict trees, the reference's
tree leaf for leaf):
  init_model(cfg, seed, device)          -> params
  train_loss(params, cfg, batch)         -> scalar loss, metrics
  prefill(params, cfg, batch)            -> last-pos logits + DecodeState
  decode_step(params, cfg, token, st)    -> logits, new DecodeState
  decode_state_specs(cfg, batch, seq)    -> a zeroed DecodeState
  param_specs(cfg)                       -> the logical sharding specs

Blocks: attention (dense, MoE every ``moe.period``-th layer, the VLM stub,
the encoder-decoder's cross-attention), Mamba2 (``ssm.py``) and RWKV-6
(``rwkv.py``) through the chunked GLA engine (``gla.py``), and zamba2's tied
``shared`` attention block, applied once per group after the group's
layers.  The recurrent archs keep no KV cache: ``prefill`` returns their
position only, and serving warms their state token by token
(``launch/serve.py``).  The reference's ``shard()`` hints stand at its
places (``models/sharding_rules.py``): no-ops without a mesh, DTensor
redistributions under ``launch/sharding.py``'s step builders.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from . import attention as attn
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .layers import (Maker, Params, StackedMaker, apply_mlp_block, embed, gelu,
                     init_embed, init_mlp_block, logits, recompute, rms_norm)
from .sharding_rules import (Spec, dense, entry, even_placements, on_shards, reduced, residual,
                             shard)

VLM_EMBED_DIM = 1024  # CLIP-large patch width (anyres frontend stub)

NORM = Spec(None)  # norm gains: replicated

DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Knobs:
    """Performance knobs (the reference's, field for field)."""

    q_chunk: int = 512
    kv_chunk: int = 1024
    gla_chunk: int = 64
    rwkv_chunk: int = 32
    gla_pair_bf16: bool = False
    aux_coef: float = 0.01


def _attn_cfg(cfg: ArchConfig) -> ArchConfig:
    """cfg for zamba2's shared full-attention block."""
    return dataclasses.replace(cfg, block_type="attn", moe=None, mlp="gelu_mlp")


def _pattern_at(cfg: ArchConfig, j: int) -> str:
    return cfg.attn_pattern[j % len(cfg.attn_pattern)]


def _is_moe(cfg: ArchConfig, j: int) -> bool:
    return cfg.moe is not None and (j % cfg.moe.period == cfg.moe.period - 1)


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(mk: Maker, cfg: ArchConfig, j: int, cross: bool = False) -> Params:
    if cfg.block_type == "mamba2":
        return {"ln": mk.zeros((cfg.d_model,), NORM),
                "mamba": ssm_mod.init_mamba(mk, cfg)}
    if cfg.block_type == "rwkv6":
        return {"ln1": mk.zeros((cfg.d_model,), NORM),
                "tm": rwkv_mod.init_rwkv_tm(mk, cfg),
                "ln2": mk.zeros((cfg.d_model,), NORM),
                "cm": init_mlp_block(mk, cfg)}
    lp: Params = {"ln1": mk.zeros((cfg.d_model,), NORM),
                  "attn": attn.init_attn(mk, cfg),
                  "ln2": mk.zeros((cfg.d_model,), NORM)}
    if cross:
        lp["lnx"] = mk.zeros((cfg.d_model,), NORM)
        lp["xattn"] = attn.init_attn(mk, cfg)
    if _is_moe(cfg, j):
        lp["moe"] = moe_mod.init_moe(mk, cfg)
    else:
        lp["ffn"] = init_mlp_block(mk, cfg)
    return lp


def _init_stack(mk: Maker, cfg: ArchConfig, cross: bool = False,
                n_layers: int | None = None) -> Params:
    n_layers = n_layers if n_layers is not None else cfg.n_layers
    g = cfg.group
    n_groups, n_rest = n_layers // g, n_layers % g
    smk = StackedMaker(mk, n_groups)
    groups = {"layers": [_init_layer(smk, cfg, j, cross) for j in range(g)]} \
        if n_groups else {"layers": []}
    rest = [_init_layer(mk, cfg, n_groups * g + r, cross) for r in range(n_rest)]
    return {"groups": groups, "rest": rest}


def _init_tree(mk: Maker, cfg: ArchConfig) -> Params:
    tree: Dict[str, Any] = {
        "embed": init_embed(mk, cfg),
        "final_norm": mk.zeros((cfg.d_model,), NORM),
        "stack": _init_stack(mk, cfg, cross=cfg.encoder is not None),
    }
    if cfg.hybrid_shared_attn_every:
        tree["shared"] = _init_layer(mk, _attn_cfg(cfg), 0)
    if cfg.encoder is not None:
        tree["enc_stack"] = _init_stack(mk, cfg, n_layers=cfg.encoder.n_layers)
        tree["enc_norm"] = mk.zeros((cfg.d_model,), NORM)
    if cfg.vlm_image_tokens:
        tree["projector"] = {"w1": mk.param((VLM_EMBED_DIM, cfg.d_model), Spec(None, "model")),
                             "w2": mk.param((cfg.d_model, cfg.d_model), Spec("model", None))}
    return tree


def init_model(cfg: ArchConfig, seed: int = 0, *, device=None,
               abstract: bool = False) -> Params:
    """Random parameters of ``cfg`` in its dtype on ``device`` (the CUDA
    device by default), drawn from a generator on that device seeded with
    ``seed``.  The tree is the reference's ``init_model`` tree, key for
    key.  ``abstract=True``: empty ``meta`` tensors of the same shapes and
    dtypes (no draw, no allocation), for planning."""
    if abstract:
        return _init_tree(Maker(None, model_dtype(cfg), torch.device("meta")), cfg)
    device = resolve_device(device)
    mk = Maker(torch.Generator(device=device).manual_seed(seed), model_dtype(cfg), device)
    return _init_tree(mk, cfg)


def param_specs(cfg: ArchConfig) -> Params:
    """The logical sharding spec of every leaf of ``init_model(cfg)``, the
    same tree built by the same init functions (the reference's
    ``init_model(cfg, abstract=True)[1]``)."""
    return _init_tree(Maker(None, model_dtype(cfg), torch.device("meta"), specs=True), cfg)


def _layer(p: Params, i: int) -> Params:
    """Group ``i`` of a stacked layer tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in p.items()}


def _leading(p: Params) -> int:
    """The leading (group) axis of a stacked layer tree."""
    while isinstance(p, dict):
        p = next(iter(p.values()))
    return p.shape[0]


def stack_layers(stack: Params, cfg: ArchConfig) -> Iterator[Tuple[int, Params]]:
    """(pattern index, layer params) of every layer of ``stack`` in order:
    the groups' layers (indexed within the group, as the reference's scan
    body does), then the rest (by absolute index)."""
    g = cfg.group
    layers = stack["groups"]["layers"]
    n_groups = _leading(layers[0]) if layers else 0
    for gi in range(n_groups):
        for j in range(g):
            yield j, _layer(layers[j], gi)
    for r, lp in enumerate(stack["rest"]):
        yield n_groups * g + r, lp


def layer_chunks(stack: Params, cfg: ArchConfig) -> List[Tuple[list, bool]]:
    """The layers of ``stack`` in the chunks the loop runs: one a group,
    recomputed in the backward under ``cfg.remat``, then the rest, never
    recomputed (as the reference checkpoints its scan body only)."""
    layers = list(stack_layers(stack, cfg))
    n = len(layers) - len(stack["rest"])
    return ([(layers[s:s + cfg.group], cfg.remat) for s in range(0, n, cfg.group)]
            + [(layers[n:], False)])


# ---------------------------------------------------------------------------
# sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _sublayer_seq(lp: Params, cfg: ArchConfig, x: torch.Tensor, j: int,
                  knobs: Knobs, *, causal: bool = True,
                  enc_out: torch.Tensor | None = None, training: bool = False):
    """One layer.  Returns (x, kv, xkv, aux): kv None for the recurrent
    blocks, xkv None without cross-attention, aux (the MoE balance loss)
    None but for a MoE layer."""
    if cfg.block_type == "mamba2":
        x = residual(x, ssm_mod.apply_mamba(lp["mamba"], cfg, entry(rms_norm(x, lp["ln"])),
                                            chunk=knobs.gla_chunk))
        return x, None, None, None
    if cfg.block_type == "rwkv6":
        x = residual(x, rwkv_mod.apply_rwkv_tm(lp["tm"], cfg, entry(rms_norm(x, lp["ln1"])),
                                               chunk=knobs.rwkv_chunk,
                                               pair_bf16=knobs.gla_pair_bf16))
        x = residual(x, apply_mlp_block(lp["cm"], cfg, entry(rms_norm(x, lp["ln2"]))))
        return x, None, None, None
    # Megatron-SP: residuals are S-sharded between groups; gather the
    # sequence once on attention entry.  Skipped for hd-sharded attention,
    # where the reference keeps GSPMD's propagated sharding.
    h = rms_norm(x, lp["ln1"])
    if not attn.q_hd_sharded(cfg):
        h = shard(h, "batch", None, None)
    h = entry(h)
    if causal:
        window = cfg.window if _pattern_at(cfg, j) == "local" else None
        a_out, akv = attn.blocked_attention(lp["attn"], cfg, h, window=window,
                                            q_chunk=knobs.q_chunk,
                                            kv_chunk=knobs.kv_chunk)
    else:
        a_out, akv = attn.full_attention(lp["attn"], cfg, h, causal=False)
    x = residual(x, a_out)
    xkv = None
    if "xattn" in lp and enc_out is not None:
        c_out, xkv = attn.full_attention(lp["xattn"], cfg, entry(rms_norm(x, lp["lnx"])),
                                         causal=False, kv_x=entry(enc_out), use_rope=False)
        x = residual(x, c_out)
    h = rms_norm(x, lp["ln2"])
    aux = None
    if "moe" in lp:
        # batch-align the dispatch input (S-sharded residuals otherwise
        # reshard inside the grouped dispatch)
        h = shard(h, "batch", None, None)
        f_out, aux = moe_mod.apply_moe(lp["moe"], cfg, entry(h), training=training)
    else:
        f_out = apply_mlp_block(lp["ffn"], cfg, entry(h))
    return residual(x, f_out), akv, xkv, aux


def _stack_seq(stack: Params, cfg: ArchConfig, x: torch.Tensor, knobs: Knobs,
               *, causal: bool = True, enc_out: torch.Tensor | None = None,
               shared: Params | None = None, collect_kv: bool = False,
               training: bool = False):
    """The groups (each followed by the ``shared`` block where given), then
    the unrolled rest.  Returns (x, aux, collected): aux the summed MoE
    balance loss (float32), collected = {"kv": [(k, v) or None per layer],
    "xkv": [(k, v) or None per layer]}, or None unless ``collect_kv``.
    The shared block's caches are not collected: only the recurrent zamba2
    has it, and its prefill assembles no cache (as the reference's)."""
    shared_cfg = _attn_cfg(cfg) if shared is not None else None
    kvs, xkvs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(x, aux, chunk, group):
        out = []
        for j, lp in chunk:
            x, kv, xkv, a = _sublayer_seq(lp, cfg, x, j, knobs, causal=causal,
                                          enc_out=enc_out, training=training)
            aux = aux if a is None else aux + a
            if collect_kv:
                out.append((kv, xkv))
        if group and shared is not None:
            x = _sublayer_seq(shared, shared_cfg, x, 0, knobs, causal=causal)[0]
        if group:
            # Megatron-SP residuals: the group-boundary activation (what
            # remat saves) is sequence-sharded over the model axis
            x = shard(x, "batch", "model", None)
        return x, aux, out

    chunks = layer_chunks(stack, cfg)
    for i, (chunk, remat) in enumerate(chunks):
        x, aux, out = recompute(run, x, aux, chunk, i < len(chunks) - 1, when=remat)
        kvs += [kv for kv, _ in out]
        xkvs += [xkv for _, xkv in out]
    return x, aux, ({"kv": kvs, "xkv": xkvs} if collect_kv else None)


def _fuse_inputs(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                 knobs: Knobs):
    """Frontend fusion; returns (x, enc_out, n_prefix)."""
    enc_out = None
    n_prefix = 0
    if cfg.encoder is not None:
        e = batch["frames"].to(model_dtype(cfg))
        e, _, _ = _stack_seq(params["enc_stack"], cfg, e, knobs, causal=False)
        enc_out = rms_norm(e, params["enc_norm"])
    x = embed(params["embed"], batch["tokens"], cfg)
    if cfg.vlm_image_tokens:
        pj = params["projector"]
        img = dense(gelu(dense(batch["image_embeds"].to(x.dtype), pj["w1"])), pj["w2"])
        x = torch.cat([img, x], dim=1)
        n_prefix = cfg.vlm_image_tokens
    return x, enc_out, n_prefix


def forward_seq(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                knobs: Knobs = Knobs(), collect_kv: bool = False,
                training: bool = False):
    """Final hidden states of the whole sequence.  Returns (x, aux,
    n_prefix, collected); ``aux`` is the MoE balance loss summed over the
    MoE layers (0 without them).  ``training`` gates training-only load
    shaping (MoE capacity drops); inference callers keep the default False
    so the sequence forward is token-order-equivalent to step-wise
    decode."""
    x, enc_out, n_prefix = _fuse_inputs(params, cfg, batch, knobs)
    x = shard(x, "batch", None, None)
    shared = params.get("shared") if cfg.hybrid_shared_attn_every else None
    x, aux, collected = _stack_seq(params["stack"], cfg, x, knobs, causal=True,
                                   enc_out=enc_out, shared=shared,
                                   collect_kv=collect_kv, training=training)
    x = rms_norm(x, params["final_norm"])
    return x, aux, n_prefix, collected


CE_CHUNK = 512


def _ce_terms(lg, top, tc, v0: int):
    """(sum of exp(lg - top), the target's logit) over the vocab slice
    ``v0 ..`` that ``lg`` holds: a one-hot contraction instead of a gather,
    which picks each logit exactly (its one nonzero term)."""
    se = torch.sum(torch.exp(lg - top), -1)
    vocab = torch.arange(v0, v0 + lg.shape[-1], device=tc.device)
    hot = (tc[..., None] == vocab).to(lg.dtype)
    return se, torch.sum(lg * hot, -1)


def _vocab_sums(lg, top, tc):
    """``_ce_terms`` of (B, S, V) logits, on each rank's vocab slice where
    they are a DTensor: both sums partial over the vocab's mesh dims, the
    batch's kept.  (DTensor would expand the sums' gradients to the whole
    vocab on every rank before slicing them.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(lg, DTensor):
        return _ce_terms(lg, top, tc, 0)
    mesh = lg.device_mesh
    coord = mesh.get_coordinate()
    pl, pt, po, idx = [], [], [], 0
    for m, p in enumerate(even_placements(lg)):
        if p == Shard(2):
            idx = idx * mesh.size(m) + coord[m]
            pl.append(p), pt.append(Replicate()), po.append(Partial())
        elif p == Shard(0):
            pl.append(p), pt.append(p), po.append(p)
        else:
            pl.append(Replicate()), pt.append(Replicate()), po.append(Replicate())
    n = math.prod(mesh.size(m) for m, p in enumerate(pl) if p == Shard(2))
    v0 = idx * (lg.shape[-1] // n)
    return on_shards(lambda lg, top, tc: _ce_terms(lg, top, tc, v0), (lg, top, tc),
                     (tuple(pl), tuple(pt), tuple(pt)), (tuple(po), tuple(po)), mesh)


def _ce_of_chunk(params, cfg, xc, tc):
    """Sum of (lse - picked) over one sequence chunk; logits never outlive
    the chunk.  The log-sum-exp is the reference's jax.nn.logsumexp (the
    max held constant), spelled out so that it stays sharded over the
    vocab (model) axis."""
    lg = logits(params["embed"], entry(xc), cfg).to(torch.float32)
    lg = shard(lg, "batch", None, "model")
    top = reduced(lg.detach().amax(-1, keepdim=True))
    se, picked = map(reduced, _vocab_sums(lg, top, tc))
    lse = torch.log(se) + top[..., 0]
    return torch.sum(lse - picked)


def train_loss(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
               knobs: Knobs = Knobs()):
    """Mean next-token cross-entropy plus ``knobs.aux_coef`` x the MoE
    balance loss, from a ``training`` forward.  Returns (loss, {"ce",
    "aux"})."""
    x, aux, n_prefix, _ = forward_seq(params, cfg, batch, knobs, training=True)
    tokens = batch["tokens"]
    if n_prefix:
        x = x[:, n_prefix:]
    x = x[:, :-1]
    tgt = tokens[:, 1:]
    n_pos = x.shape[0] * x.shape[1]
    s = x.shape[1]
    if s % CE_CHUNK == 0 and s > CE_CHUNK:
        ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(s // CE_CHUNK):
            xc = x[:, c * CE_CHUNK:(c + 1) * CE_CHUNK]
            tc = tgt[:, c * CE_CHUNK:(c + 1) * CE_CHUNK]
            ce_sum = ce_sum + recompute(
                lambda xc, tc: _ce_of_chunk(params, cfg, xc, tc), xc, tc)
    else:
        ce_sum = _ce_of_chunk(params, cfg, x, tgt)
    ce = ce_sum / n_pos
    loss = ce + knobs.aux_coef * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------

def decode_state_specs(cfg: ArchConfig, batch: int, seq: int, *, device=None,
                       abstract: bool = False) -> Dict[str, Any]:
    """A zeroed decode state for ``batch`` rows and a ring of ``seq``
    entries, at position ``seq - 1``, on ``device`` (the CUDA device by
    default): the attention layers' KV caches (in the model's dtype), the
    recurrent blocks' states (float32, as the reference keeps them), and
    the shared block's caches, one per group.  ``abstract=True``: the same
    tree of empty ``meta`` tensors (the reference's shape-only variant),
    for planning."""
    device = torch.device("meta") if abstract else resolve_device(device)
    kv_dtype = model_dtype(cfg)
    st: Dict[str, Any] = {"pos": torch.tensor(seq - 1, dtype=torch.long, device=device)}
    if cfg.block_type == "attn":
        st["kv"] = attn.init_kv_cache(cfg, batch, seq, cfg.n_layers, kv_dtype, device)
    if cfg.block_type == "mamba2":
        st["mamba"] = ssm_mod.init_mamba_state(cfg, batch, cfg.n_layers, device=device)
    if cfg.block_type == "rwkv6":
        st["rwkv"] = rwkv_mod.init_rwkv_state(cfg, batch, cfg.n_layers, device=device)
    if cfg.hybrid_shared_attn_every:
        st["shared_kv"] = attn.init_kv_cache(_attn_cfg(cfg), batch, seq,
                                             cfg.n_layers // cfg.group, kv_dtype, device)
    if cfg.encoder is not None:
        st["cross_kv"] = attn.init_kv_cache(cfg, batch, cfg.encoder.seq, cfg.n_layers,
                                            kv_dtype, device)
    return st


# the per-layer stacked entries decode_step writes, and the shared block's
_STATE_KEYS = ("kv", "mamba", "rwkv", "shared_kv")


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _slice(state: tuple, i: int) -> tuple:
    """Layer ``i``'s slice of each leaf of a stacked state (views)."""
    return type(state)(*(leaf[i] for leaf in state))


def _write(state: tuple, i: int, new: tuple) -> None:
    """Layer ``i``'s slice of each leaf of ``state``, in place (rounded to
    the leaf's dtype)."""
    for leaf, value in zip(state, new):
        leaf[i].copy_(value)


def _sublayer_decode(lp: Params, cfg: ArchConfig, x, j: int, li: int,
                     st: Dict[str, Any], pos):
    """Layer ``li`` (pattern index ``j``) on one token.  Writes the layer's
    slice of ``st``'s KV cache or recurrent state in place."""
    if cfg.block_type == "mamba2":
        out, ms = ssm_mod.mamba_decode_step(lp["mamba"], cfg, rms_norm(x, lp["ln"]),
                                            _slice(st["mamba"], li))
        _write(st["mamba"], li, ms)
        return residual(x, out)
    if cfg.block_type == "rwkv6":
        wkv, shift_tm, shift_cm = _slice(st["rwkv"], li)
        h = rms_norm(x, lp["ln1"])
        out, new_wkv, _ = rwkv_mod.rwkv_tm_decode_step(lp["tm"], cfg, h, wkv, shift_tm)
        x = residual(x, out)
        h2 = rms_norm(x, lp["ln2"])
        cm_out = apply_mlp_block(lp["cm"], cfg, h2, x_prev=shift_cm)
        _write(st["rwkv"], li, (new_wkv, h, h2))
        return residual(x, cm_out)
    window = cfg.window if _pattern_at(cfg, j) == "local" else None
    out, _ = attn.decode_attention(lp["attn"], cfg, rms_norm(x, lp["ln1"]),
                                   _slice(st["kv"], li), pos, window=window)
    x = residual(x, out)
    if "xattn" in lp and "cross_kv" in st:
        cout, _ = attn.decode_attention(lp["xattn"], cfg, rms_norm(x, lp["lnx"]),
                                        _slice(st["cross_kv"], li), pos, window=None,
                                        cross=True)
        x = residual(x, cout)
    h = rms_norm(x, lp["ln2"])
    f_out = (moe_mod.apply_moe(lp["moe"], cfg, h)[0] if "moe" in lp
             else apply_mlp_block(lp["ffn"], cfg, h))
    return residual(x, f_out)


def _shared_decode(shared: Params, cfg: ArchConfig, x, gi: int, st: Dict[str, Any], pos):
    """zamba2's shared block after group ``gi`` on one token; writes its
    slice of ``st["shared_kv"]`` in place."""
    acfg = _attn_cfg(cfg)
    out, _ = attn.decode_attention(shared["attn"], acfg, rms_norm(x, shared["ln1"]),
                                   _slice(st["shared_kv"], gi), pos, window=None)
    x = residual(x, out)
    return residual(x, apply_mlp_block(shared["ffn"], acfg, rms_norm(x, shared["ln2"])))


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor, st: Dict[str, Any]):
    """token: (B, 1) integers.  Returns (logits (B, V), new state); ``st``
    is left as it was: its KV caches and recurrent states are copied once,
    as the reference's step copies them, and each layer writes its slice of
    the copy in place."""
    pos = st["pos"]
    x = shard(embed(params["embed"], token, cfg), "batch", None, None)
    new_st = dict(st)
    for key in _STATE_KEYS:
        if key in st:
            new_st[key] = type(st[key])(*(leaf.clone() for leaf in st[key]))
    g = cfg.group
    n_grouped = (cfg.n_layers // g) * g
    shared = params.get("shared") if cfg.hybrid_shared_attn_every else None
    for li, (j, lp) in enumerate(stack_layers(params["stack"], cfg)):
        x = _sublayer_decode(lp, cfg, x, j, li, new_st, pos)
        if shared is not None and li < n_grouped and li % g == g - 1:
            x = _shared_decode(shared, cfg, x, li // g, new_st, pos)
    new_st["pos"] = pos + 1
    x = rms_norm(x, params["final_norm"])
    return logits(params["embed"], x, cfg)[:, 0], new_st


# ---------------------------------------------------------------------------
# prefill (attention-cache architectures)
# ---------------------------------------------------------------------------

def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            knobs: Knobs = Knobs(), pad_to: int | None = None):
    """Full-sequence forward that also builds the decode caches.

    ``pad_to`` sets the ring-buffer capacity (must exceed the prompt length
    by the number of tokens to be generated, or the ring evicts the oldest
    entries -- which is the intended streaming behavior at capacity).  The
    caches are the layers' post-rope k/v in layer order, zero-padded to the
    capacity; the encoder-decoder's cross caches keep the encoder's length
    (never ring-written).  The recurrent archs (mamba2, rwkv6, and zamba2
    with its shared block) assemble no state here, as in the reference:
    they get their position alone, and serving warms their state by
    step-wise decode.  Returns (last-position logits, DecodeState).
    """
    attn_cache = cfg.block_type == "attn"
    x, _, _, collected = forward_seq(params, cfg, batch, knobs, collect_kv=attn_cache)
    lg = logits(params["embed"], x[:, -1:], cfg)[:, 0]
    seq = x.shape[1]
    cap = pad_to or seq
    if cap < seq:
        raise ValueError(f"pad_to {cap} is below the prefilled length {seq}")
    st: Dict[str, Any] = {"pos": torch.tensor(seq, dtype=torch.long, device=x.device)}
    if not attn_cache:
        return lg, st

    def stacked(kvs) -> attn.KVCache:
        return attn.KVCache(torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))

    kv = stacked(collected["kv"])
    if cap > seq:
        kv = attn.KVCache(*(F.pad(c, (0, 0, 0, 0, 0, cap - seq)) for c in kv))
    st["kv"] = kv
    if cfg.encoder is not None:
        st["cross_kv"] = stacked(collected["xkv"])
    return lg, st
