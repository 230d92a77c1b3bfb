"""Compositional jet-modules: the blocks every Network is built from.

A :class:`Module` is the smallest jet-traceable unit -- ``init`` / ``apply``
/ ``jet_apply`` with exactly the Network contract
(``repro_torch.core.network``):

* **leaves** own parameters and the jet rules for one operation --
  :class:`Dense` (with the fused ``jet_dense`` kernel path),
  :class:`Activation`, :class:`FourierFeatures`, and the transformer
  trunk's :class:`RMSNorm`,
  :class:`SelfAttention`, :class:`MLPBlock`, :class:`CoordinateEmbedding`
  and :class:`TokenPool`;
* **combinators** own structure only -- :class:`Sequential` (params are a
  tuple, one entry per child, drawn from the generator in child order) and
  :class:`Residual` (``x + inner(x)``; jet addition is exact).

``impl="cuda"`` routes every Dense contraction through
``repro_torch.kernels.ops.jet_dense``, fusing the activation into the
kernel's epilogue when ``ops.epilogues()`` marks the name ``ACTIVATION``,
every RMSNorm through ``ops.jet_rms_norm`` and everything of an attention
layer after its q/k/v projections through ``ops.jet_flash_attention`` (the
``"rms_norm"`` / ``"flash_attention"`` ``FUSED_OP`` entries of the same
registry); anything unfused runs the jet algebra, so a module mixes kernel
and eager paths freely.  ``SelfAttention`` carries the attention-mask
surface (``mask=None | "causal" | ("local", window)``, canonicalized by
:func:`normalize_attention_mask`), honoured alike by the primal ``apply``,
the eager jet path (``J.softmax(mask=...)``) and the flash kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.device import resolve_device

from . import jet as J
from .activations import PRIMALS
from .ntp import xavier_uniform

Params = Any  # parameter tree; structure owned by the module

IMPLS = ("torch", "cuda")


class Module:
    """Smallest jet-traceable unit: the Network contract without metadata."""

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        return ()

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def jet_apply(self, params: Params, jet: J.Jet, *,
                  impl: str = "torch") -> J.Jet:
        raise NotImplementedError


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want 'torch' or 'cuda')")


def _is_activation_epilogue(name: str) -> bool:
    """Can the dense kernel run ``name`` in its Faa di Bruno epilogue?  The
    FUSED_OP entries ("rms_norm", "flash_attention") are not dense
    epilogues and take their own dispatch."""
    from repro_torch.kernels import ops as kops
    return kops.epilogues().get(name) is kops.EpilogueKind.ACTIVATION


# every canonical attention-mask kind normalize_attention_mask can emit
ATTENTION_MASK_KINDS = ("none", "causal", "local")


def normalize_attention_mask(mask) -> tuple:
    """Canonicalize an attention-mask spec to a hashable ``(kind, window)``
    pair: ``None``/"none" -> ("none", 0), "causal" -> ("causal", 0),
    ("local", w) -> ("local", int(w)) with w >= 1.  The single validation
    point shared by :class:`SelfAttention` and the flash-kernel dispatch in
    ``repro_torch.kernels.ops``."""
    if mask is None or mask == "none" or mask == ("none", 0):
        return ("none", 0)
    if mask == "causal" or mask == ("causal", 0):
        return ("causal", 0)
    if (isinstance(mask, (tuple, list)) and len(mask) == 2
            and mask[0] == "local"):
        window = int(mask[1])
        if window < 1:
            raise ValueError(f"local attention window must be >= 1, "
                             f"got {mask[1]!r}")
        return ("local", window)
    raise ValueError(f"unknown attention mask {mask!r}; want None, "
                     "'causal', or ('local', window)")


def attention_mask(mask, t: int, device=None) -> torch.Tensor | None:
    """Dense (T, T) boolean keep-matrix for a mask spec (None for "none"),
    on ``device`` (the CPU by default): what the eager softmax path, the
    primal forward and the flash kernel's backward recompute consume.
    ``local(w)`` is a causal sliding window -- query q attends keys j with
    ``q - w < j <= q`` -- so the diagonal is always kept and no query row
    is ever fully masked."""
    kind, window = normalize_attention_mask(mask)
    if kind == "none":
        return None
    qi = torch.arange(t, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    keep = kj <= qi
    if kind == "local":
        keep = keep & ((qi - kj) < window)
    return keep


def dense_jet(jet: J.Jet, w: torch.Tensor, b: torch.Tensor | None,
              activation: str | None, impl: str) -> J.Jet:
    """One dense contraction (+ optional activation) on a jet, dispatched.

    ``impl="cuda"`` runs the fused kernel (activation folded into its
    epilogue when the table exists, else the kernel computes the linear part
    and the activation composes through the jet algebra); ``impl="torch"``
    is the eager algebra.  Arbitrary leading batch axes are supported by
    both paths.
    """
    _check_impl(impl)
    if impl == "cuda":
        from repro_torch.kernels import ops as kops
        if b is None:
            b = torch.zeros((w.shape[1],), dtype=jet.dtype, device=jet.device)
        if activation is None or _is_activation_epilogue(activation):
            return J.Jet(kops.jet_dense(jet.coeffs, w, b, activation))
        out = J.Jet(kops.jet_dense(jet.coeffs, w, b, None))
        return J.activation(out, activation)
    out = J.linear(jet, w, b)
    if activation is not None:
        out = J.activation(out, activation)
    return out


# ---------------------------------------------------------------------------
# leaf modules
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Dense(Module):
    """``act(x @ w + b)`` -- params ``(w, b)``; ``activation=None`` is the
    linear readout.  The jet path is the fused layer of Algorithm 1."""

    d_in: int
    d_out: int
    activation: str | None = None

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        device = resolve_device(device)
        return (xavier_uniform(generator, self.d_in, self.d_out, dtype, device),
                torch.zeros((self.d_out,), dtype=dtype, device=device))

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        w, b = params
        y = x @ w + b
        return PRIMALS[self.activation](y) if self.activation else y

    def jet_apply(self, params: Params, jet: J.Jet, *,
                  impl: str = "torch") -> J.Jet:
        w, b = params
        return dense_jet(jet, w, b, self.activation, impl)


@dataclass(frozen=True)
class Activation(Module):
    """Pointwise activation as its own (stateless) block.  Under
    ``impl="cuda"`` a table-backed activation runs the standalone Faa di
    Bruno kernel (``ops.act_jet``); anything else composes through the
    algebra."""

    name: str

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return PRIMALS[self.name](x)

    def jet_apply(self, params: Params, jet: J.Jet, *,
                  impl: str = "torch") -> J.Jet:
        _check_impl(impl)
        if impl == "cuda" and _is_activation_epilogue(self.name):
            from repro_torch.kernels import ops as kops
            return J.Jet(kops.act_jet(jet.coeffs, self.name))
        return J.activation(jet, self.name)


@dataclass(frozen=True)
class FourierFeatures(Module):
    """``gamma(x) = [sin(2pi B x), cos(2pi B x)]`` with fixed Gaussian ``B``
    (Tancik et al. 2020).  Params are the bare ``B`` tensor, excluded from
    gradients (``detach``, the reference's stop_gradient); the jet is exact
    (``sin`` through Faa di Bruno, ``cos z = sin(z + pi/2)`` reusing the same
    table).  The embedding stays jet algebra under either impl, as in the
    reference."""

    d_in: int
    n_features: int
    scale: float = 1.0

    @property
    def d_out(self) -> int:
        return 2 * self.n_features

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        device = resolve_device(device)
        b = torch.randn((self.d_in, self.n_features), generator=generator,
                        dtype=dtype)
        return (self.scale * b).to(device)

    def _freqs(self, B: torch.Tensor) -> torch.Tensor:
        return 2.0 * math.pi * B.detach()

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        z = x @ self._freqs(params)
        return torch.cat([torch.sin(z), torch.cos(z)], dim=-1)

    def jet_apply(self, params: Params, jet: J.Jet, *,
                  impl: str = "torch") -> J.Jet:
        _check_impl(impl)
        z = J.linear(jet, self._freqs(params))
        s = J.compose(z, "sin")
        c = J.compose(J.add(z, 0.5 * math.pi), "sin")  # cos z = sin(z + pi/2)
        return J.jmap(lambda a, b: torch.cat([a, b], dim=-1), s, c)


@dataclass(frozen=True)
class RMSNorm(Module):
    """Pre-norm RMS normalization over the trailing feature axis; params are
    the gain ``gamma`` (ones-init).  Smooth everywhere (rsqrt of a positive
    mean square), so the jet is exact at every order.  Under
    ``impl="cuda"`` the whole chain (mean-square convolution, rsqrt
    recurrence, gain) runs as the fused ``ops.jet_rms_norm`` kernel."""

    dim: int
    eps: float = 1e-6

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        return torch.ones((self.dim,), dtype=dtype, device=resolve_device(device))

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        ms = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(ms + self.eps) * params

    def jet_apply(self, params: Params, jet: J.Jet, *,
                  impl: str = "torch") -> J.Jet:
        _check_impl(impl)
        if impl == "cuda":
            from repro_torch.kernels import ops as kops
            return J.Jet(kops.jet_rms_norm(jet.coeffs, params, eps=self.eps))
        return J.rms_norm(jet, params, eps=self.eps)


@dataclass(frozen=True)
class SelfAttention(Module):
    """Multi-head scaled-dot-product self-attention over the token axis
    (``x``: (..., T, dim)); params ``{"wq", "wk", "wv", "wo"}``, each
    (dim, dim).  Scores are a jet x jet Cauchy-convolved einsum, softmax
    goes through the exp/div power-series recurrences, and the value
    contraction is a second jet x jet einsum.

    ``mask``: ``None`` (dense), ``"causal"``, or ``("local", window)`` -- a
    causal sliding window where query q attends keys j with
    ``q - window < j <= q``.

    Under ``impl="cuda"`` the q/k/v projections run the dense kernel and
    everything downstream -- Cauchy QK^T, scale, masked softmax, value
    contraction, output projection -- runs as ONE flash-jet launch
    (``ops.jet_flash_attention``), so the (Tq, Tk) score jet never reaches
    device memory."""

    dim: int
    n_heads: int = 2
    mask: Any = None

    def __post_init__(self):
        if self.dim % self.n_heads:
            raise ValueError(f"dim={self.dim} not divisible by "
                             f"n_heads={self.n_heads}")
        # canonicalize (and validate) so equal masks hash equal and the
        # spec stays hashable inside the frozen dataclass
        kind, window = normalize_attention_mask(self.mask)
        canon = None if kind == "none" else \
            ("causal" if kind == "causal" else (kind, window))
        object.__setattr__(self, "mask", canon)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        device = resolve_device(device)
        return {name: xavier_uniform(generator, self.dim, self.dim, dtype,
                                     device)
                for name in ("wq", "wk", "wv", "wo")}

    def _split_heads(self, c: torch.Tensor) -> torch.Tensor:
        return c.reshape(tuple(c.shape[:-1]) + (self.n_heads, self.head_dim))

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        q = self._split_heads(x @ params["wq"])
        k = self._split_heads(x @ params["wk"])
        v = self._split_heads(x @ params["wv"])
        s = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(self.head_dim)
        keep = attention_mask(self.mask, x.shape[-2], x.device)
        if keep is not None:
            s = torch.where(keep, s, torch.full_like(s, J.MASK_NEG))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("...hqk,...khd->...qhd", p, v)
        return o.reshape(tuple(o.shape[:-2]) + (self.dim,)) @ params["wo"]

    def jet_apply(self, params: Params, jet: J.Jet, *,
                  impl: str = "torch") -> J.Jet:
        split = lambda j: J.Jet(self._split_heads(j.coeffs))
        q = split(dense_jet(jet, params["wq"], None, None, impl))
        k = split(dense_jet(jet, params["wk"], None, None, impl))
        v = split(dense_jet(jet, params["wv"], None, None, impl))
        scale = 1.0 / math.sqrt(self.head_dim)
        if impl == "cuda":
            # one launch for the rest of the block; the head axis stays
            # inside the kernel so the output projection (which mixes
            # heads) folds into its epilogue
            from repro_torch.kernels import ops as kops
            to_heads = lambda c: c.movedim(-2, -3)        # (..., H, T, Dh)
            return J.Jet(kops.jet_flash_attention(
                to_heads(q.coeffs), to_heads(k.coeffs), to_heads(v.coeffs),
                params["wo"], scale, mask=self.mask))
        s = J.scale(J.einsum("...qhd,...khd->...hqk", q, k), scale)
        p = J.softmax(s, axis=-1, mask=attention_mask(
            self.mask, jet.shape[-2], jet.device))
        o = J.einsum("...hqk,...khd->...qhd", p, v)
        o = J.Jet(o.coeffs.reshape(tuple(o.coeffs.shape[:-2]) + (self.dim,)))
        return dense_jet(o, params["wo"], None, None, impl)


@dataclass(frozen=True)
class MLPBlock(Module):
    """Transformer feed-forward: ``Dense(dim, hidden, act) -> Dense(hidden,
    dim)``; params are the inner :class:`Sequential`'s tuple."""

    dim: int
    hidden: int
    activation: str = "tanh"

    def _seq(self) -> "Sequential":
        return Sequential((Dense(self.dim, self.hidden, self.activation),
                           Dense(self.hidden, self.dim, None)))

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        return self._seq().init(generator, dtype, device)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self._seq().apply(params, x)

    def jet_apply(self, params: Params, jet: J.Jet, *,
                  impl: str = "torch") -> J.Jet:
        return self._seq().jet_apply(params, jet, impl=impl)


@dataclass(frozen=True)
class CoordinateEmbedding(Module):
    """Tokens from coordinates: input point ``x`` (..., d_in) becomes d_in
    tokens, token t = ``x_t * w[t] + b[t]`` (..., d_in, dim).  Each
    coordinate gets its own embedding row, so ``w``/``b`` double as learned
    positional encodings; the map is linear, hence jet-exact (the bias
    lands on coefficient 0 only)."""

    d_in: int
    dim: int

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        device = resolve_device(device)
        return (xavier_uniform(generator, self.d_in, self.dim, dtype, device),
                torch.zeros((self.d_in, self.dim), dtype=dtype, device=device))

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        w, b = params
        return x[..., :, None] * w + b

    def jet_apply(self, params: Params, jet: J.Jet, *,
                  impl: str = "torch") -> J.Jet:
        _check_impl(impl)
        w, b = params
        coeffs = jet.coeffs[..., :, None] * w
        return J.Jet(torch.cat([coeffs[:1] + b, coeffs[1:]]))


@dataclass(frozen=True)
class TokenPool(Module):
    """Mean over the token axis (..., T, dim) -> (..., dim); linear, so the
    jet reduces coefficient-wise."""

    axis: int = -2

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=self.axis)

    def jet_apply(self, params: Params, jet: J.Jet, *,
                  impl: str = "torch") -> J.Jet:
        _check_impl(impl)
        return J.reduce_mean(jet, axis=self.axis)


# ---------------------------------------------------------------------------
# combinators
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Sequential(Module):
    """Compose modules left to right.  Params are a tuple with one entry per
    child; ``init`` draws each child's parameters from the generator in
    order, so a graph's initialization is a pure function of its structure
    and the seed."""

    modules: Tuple[Module, ...]

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        device = resolve_device(device)
        return tuple(m.init(generator, dtype, device) for m in self.modules)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        for m, p in zip(self.modules, params):
            x = m.apply(p, x)
        return x

    def jet_apply(self, params: Params, jet: J.Jet, *,
                  impl: str = "torch") -> J.Jet:
        for m, p in zip(self.modules, params):
            jet = m.jet_apply(p, jet, impl=impl)
        return jet


@dataclass(frozen=True)
class Residual(Module):
    """``x + inner(x)``: params are the inner module's.  Jet addition is
    coefficient-wise, so the skip is exact at every derivative order."""

    inner: Module

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        return self.inner.init(generator, dtype, device)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return x + self.inner.apply(params, x)

    def jet_apply(self, params: Params, jet: J.Jet, *,
                  impl: str = "torch") -> J.Jet:
        return J.add(jet, self.inner.jet_apply(params, jet, impl=impl))


# ---------------------------------------------------------------------------
# leaf registry: named factories for configs / conversion tools
# ---------------------------------------------------------------------------

ModuleFactory = Callable[..., Module]

_MODULES: Dict[str, ModuleFactory] = {}


def register_module(name: str, factory: ModuleFactory) -> None:
    if name in _MODULES:
        raise ValueError(f"module {name!r} already registered")
    _MODULES[name] = factory


def module_names() -> Tuple[str, ...]:
    return tuple(sorted(_MODULES))


def make_module(name: str, **kwargs) -> Module:
    if name not in _MODULES:
        raise KeyError(f"unknown module {name!r}; known: {module_names()}")
    return _MODULES[name](**kwargs)


for _name, _factory in (
    ("dense", Dense),
    ("activation", Activation),
    ("fourier_features", FourierFeatures),
    ("rms_norm", RMSNorm),
    ("self_attention", SelfAttention),
    ("mlp_block", MLPBlock),
    ("coordinate_embedding", CoordinateEmbedding),
    ("token_pool", TokenPool),
    ("sequential", Sequential),
    ("residual", Residual),
):
    register_module(_name, _factory)
