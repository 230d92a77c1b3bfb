"""Shared building blocks: norms, RoPE, MLPs, embeddings, softcaps.

Parameters are plain dicts of tensors, the tree the JAX package's
``models/layers.py`` builds, key for key, so
``repro_torch.bridge.params_from_numpy`` carries its parameters across
unchanged.  The arithmetic is the reference's, float32 islands included:
``rms_norm`` takes its mean square and ``rope`` its angles in float32
whatever the model's dtype, as the reference does.

Every init takes, leaf by leaf, the logical :class:`~.sharding_rules.Spec`
the reference gives its ``PartitionSpec``.  One init function builds three
trees, so they match by construction (the reference's ``Boxed``/``unzip``):
a :class:`Maker` draws values, one on the ``meta`` device builds
shape-and-dtype stand-ins (no draw, no allocation), and one made with
``specs=True`` returns each leaf's logical spec.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig

from .sharding_rules import Spec, dense, even_placements, on_shards, reduced

Params = Dict[str, Any]


BIG_LEAF = 2 ** 31  # elements; such a leaf is drawn a slice of its first axis at a time


class Maker:
    """Creates initialized parameters of ``dtype`` on ``device``, drawing
    from ``generator`` (which must live on ``device``) in call order:
    fan-in normal draws in float32, rounded to ``dtype``.  A leaf of
    BIG_LEAF elements or more (llama4's 128 experts of 5120 x 2 x 8192) is
    drawn slice by slice along its first axis, so its float32 draw is
    never held whole (43 GB there).

    On the ``meta`` device it draws nothing and returns empty stand-ins of
    the leaves' shapes and dtype; with ``specs=True`` it returns each
    leaf's logical spec instead (vocabulary: "model" for tensor
    parallelism, "fsdp" for weight sharding, None replicated; bound to mesh
    axes in ``launch/sharding.py``)."""

    def __init__(self, generator: torch.Generator | None, dtype: torch.dtype,
                 device: torch.device, *, specs: bool = False):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.specs = specs

    @property
    def abstract(self) -> bool:
        return self.specs or self.device.type == "meta"

    def _abstract(self, shape, spec: Spec):
        if self.specs:
            return Spec(*spec)
        return torch.empty(shape, dtype=self.dtype, device="meta")

    def param(self, shape, spec: Spec, scale: float | None = None):
        shape = tuple(shape)
        if self.abstract:
            return self._abstract(shape, spec)
        scale = fan_in_scale(shape) if scale is None else scale
        if len(shape) > 1 and math.prod(shape) >= BIG_LEAF:
            leaf = torch.empty(shape, dtype=self.dtype, device=self.device)
            for i in range(shape[0]):
                leaf[i] = self.param(shape[1:], Spec(*spec[1:]), scale=scale)
            return leaf
        leaf = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                           device=self.device)
        return leaf.mul_(scale).to(self.dtype)

    def zeros(self, shape, spec: Spec):
        if self.abstract:
            return self._abstract(tuple(shape), spec)
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)


def fan_in_scale(shape) -> float:
    """The fan-in normal init's standard deviation for a leaf of ``shape``."""
    return (shape[-2] if len(shape) >= 2 else shape[-1]) ** -0.5


class StackedMaker(Maker):
    """Maker that prepends a layer-group axis to every parameter it creates
    (and a None to its spec), so one init function written for a single
    layer builds the (n_groups, ...) leaves the group loop indexes.  Each
    group's slice is drawn on its own into the stacked leaf (the scale that
    of the stacked shape), so no float32 draw of a whole stacked leaf is
    ever held."""

    def __init__(self, base: Maker, lead: int):
        super().__init__(base.generator, base.dtype, base.device, specs=base.specs)
        self._base = base
        self._lead = lead

    def param(self, shape, spec: Spec, scale: float | None = None):
        full = (self._lead,) + tuple(shape)
        if self.abstract:
            return self._base.param(full, Spec(None, *spec), scale=scale)
        scale = fan_in_scale(full) if scale is None else scale
        leaf = torch.empty(full, dtype=self.dtype, device=self.device)
        for i in range(self._lead):
            leaf[i] = self._base.param(shape, spec, scale=scale)
        return leaf

    def zeros(self, shape, spec: Spec):
        return self._base.zeros((self._lead,) + tuple(shape), Spec(None, *spec))


# logical spec aliases (bound to physical axes in launch/sharding.py)
REPL = Spec()
COL = Spec(None, "model")            # (d_in, d_out/TP)  column-parallel
ROW = Spec("model", None)            # (d_in/TP, d_out)  row-parallel
VOCAB = Spec("model", None)          # embedding table rows over TP


def recompute(fn, *args, when: bool = True):
    """``fn(*args)``, recomputed in the backward instead of saved (the
    reference's ``jax.checkpoint``) when ``when`` holds and autograd
    records."""
    if when and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (x32 * inv).to(dt) * (1.0 + gamma.to(dt))


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integers."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([(x1 * cos - x2 * sin).to(x.dtype),
                      (x2 * cos + x1 * sin).to(x.dtype)], dim=-1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU (the reference's ``approximate=True``)."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# dense FFNs
# ---------------------------------------------------------------------------

def init_mlp_block(mk: Maker, cfg: ArchConfig) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {"wi": mk.param((d, 2, f), Spec(None, None, "model")),  # fused gate+up
                "wo": mk.param((f, d), ROW)}
    if cfg.mlp == "gelu_mlp":
        return {"wi": mk.param((d, f), COL), "wo": mk.param((f, d), ROW)}
    if cfg.mlp == "rwkv_channel_mix":
        return {"mix_k": mk.param((d,), REPL, scale=0.1),
                "wk": mk.param((d, f), COL),
                "wv": mk.param((f, d), ROW),
                "wr": mk.param((d, d), REPL)}
    raise ValueError(cfg.mlp)


def apply_mlp_block(p: Params, cfg: ArchConfig, x: torch.Tensor,
                    x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """``x_prev``: the channel mix's token-shift carry (B, 1, D), the last
    token of the previous segment (decode), or None from a sequence's
    start; the other MLPs ignore it."""
    if cfg.mlp in ("swiglu", "geglu"):
        # the reference's one einsum into (gate, up) as two products: DTensor
        # merges the (2, F) of a d_ff-sharded weight into a strided shard
        gate, up = dense(x, p["wi"][:, 0]), dense(x, p["wi"][:, 1])
        act = F.silu(gate) if cfg.mlp == "swiglu" else gelu(gate)
        return dense(act * up, p["wo"])
    if cfg.mlp == "gelu_mlp":
        return dense(gelu(dense(x, p["wi"])), p["wo"])
    if cfg.mlp == "rwkv_channel_mix":
        # RWKV channel mix: token-shifted key, squared relu, receptance gate
        xs = token_shift(x, x_prev)
        xk = x + (xs - x) * p["mix_k"]
        k = torch.square(torch.relu(dense(xk, p["wk"])))
        r = torch.sigmoid(dense(x, p["wr"]))
        return r * reduced(dense(k, p["wv"]))
    raise ValueError(cfg.mlp)


def token_shift(x: torch.Tensor, x_prev: torch.Tensor | None) -> torch.Tensor:
    """RWKV token shift: the previous token's features (zeros, or the
    carried ``x_prev`` (B, 1, D), at t = 0).  x: (B, S, D)."""
    first = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev.to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def init_embed(mk: Maker, cfg: ArchConfig) -> Params:
    p = {"table": mk.param((cfg.vocab, cfg.d_model), VOCAB, scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        p["lm_head"] = mk.param((cfg.d_model, cfg.vocab), COL)
    return p


def _rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table's rows are gathered on each
    rank's slice of the vocabulary, a token outside it giving zeros, and
    summed over the vocabulary's mesh dims (exact: one rank holds each
    row); DTensor (torch 2.11) has no rule for a gather by tokens sharded
    over two mesh dims, nor for the gather's backward."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    tp = even_placements(table)
    kp = even_placements(tokens) if isinstance(tokens, DTensor) else (Replicate(),) * mesh.ndim
    coord = mesh.get_coordinate()
    pt, pk, po, idx, n = [], [], [], 0, 1
    for m in range(mesh.ndim):
        if tp[m] == Shard(0):
            idx, n = idx * mesh.size(m) + coord[m], n * mesh.size(m)
            pt.append(Shard(0)), pk.append(Replicate()), po.append(Partial())
        elif kp[m] == Shard(0):
            pt.append(Replicate()), pk.append(Shard(0)), po.append(Shard(0))
        else:
            pt.append(Replicate()), pk.append(Replicate()), po.append(Replicate())
    v0 = idx * (table.shape[0] // n)

    def gather(t, k):
        rows = k - v0
        inside = (rows >= 0) & (rows < t.shape[0])
        return t[rows.clamp(0, t.shape[0] - 1)] * inside[..., None].to(t.dtype)

    return on_shards(gather, (table, tokens), (tuple(pt), tuple(pk)), po, mesh)


def embed(p: Params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = _rows(p["table"], tokens)
    # the scale rounded to the table's dtype first, as the reference does
    return x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)


def logits(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = dense(x, p["table"].t())
    else:
        out = dense(x, p["lm_head"])
    return softcap(out, cfg.logit_softcap)
