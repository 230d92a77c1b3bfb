"""Jet-traceable network architectures for the derivative engines.

A :class:`Network` is an object with

* ``init(generator, dtype, device)`` -- parameter construction;
* ``apply(params, x)``               -- plain forward (N, d_in) -> (N, d_out);
* ``jet_apply(params, jet, impl=)``  -- push a :class:`repro_torch.core.jet.Jet`
  of the inputs through the network.  ``impl="torch"`` runs the eager jet
  algebra; ``impl="cuda"`` routes every dense layer through the fused
  kernel dispatch (kernels/ops.jet_dense).

Every shipped network is a thin composition over the jet-module layer
(:mod:`repro_torch.core.modules`): it declares a module graph and adapts its
public parameter tree onto that graph.

=================  ==========================================================
DenseMLP           uniform-width MLP over :class:`repro_torch.core.ntp.MLPParams`
MLP                variable per-layer widths
ResidualMLP        skip-connected MLP (params ``{"w_in", "b_in", "blocks",
                   "w_out", "b_out"}``)
FourierFeatureMLP  random Fourier-feature embedding + MLP (``{"B", "mlp"}``)
Transformer        pre-norm self-attention trunk over coordinate tokens
=================  ==========================================================
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.device import resolve_device

from . import jet as J
from .modules import (CoordinateEmbedding, Dense, FourierFeatures, MLPBlock, Module,
                      Residual, RMSNorm, SelfAttention, Sequential, TokenPool)
from .ntp import MLPParams, init_mlp, mlp_apply, xavier_uniform

Params = Any  # parameter tree; its structure is owned by the network


@runtime_checkable
class Network(Protocol):
    """Anything the derivative engines can differentiate."""

    d_in: int
    d_out: int
    activation: str

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params: ...

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor: ...

    def jet_apply(self, params: Params, jet: J.Jet, *,
                  impl: str = "torch") -> J.Jet: ...


class _Composed:
    """Mixin: a network that IS a module graph.

    Subclasses provide ``_graph()`` (the module composition) and, when the
    public parameter tree is not already the graph's tuple layout,
    ``_graph_params(params)`` to adapt it (a re-view, never a copy).
    """

    def _graph(self) -> Module:
        raise NotImplementedError

    def _graph_params(self, params: Params) -> Params:
        return params

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self._graph().apply(self._graph_params(params), x)

    def jet_apply(self, params: Params, jet: J.Jet, *,
                  impl: str = "torch") -> J.Jet:
        return self._graph().jet_apply(self._graph_params(params), jet,
                                       impl=impl)


@dataclass(frozen=True)
class DenseMLP(_Composed):
    """Uniform-width MLP; params are :class:`MLPParams`, adapted onto a
    Sequential of Dense leaves at call time (the readout is a Dense with
    ``activation=None``, so under ``impl="cuda"`` it runs the kernel too)."""

    d_in: int
    width: int
    depth: int
    d_out: int
    activation: str = "tanh"

    @classmethod
    def from_params(cls, params: MLPParams, activation: str = "tanh") -> "DenseMLP":
        """Recover the architecture from a parameter tree."""
        return cls(d_in=params.w_in.shape[0], width=params.w_in.shape[1],
                   depth=params.w_hidden.shape[0] + 1,
                   d_out=params.w_out.shape[1], activation=activation)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> MLPParams:
        return init_mlp(generator, self.d_in, self.width, self.depth,
                        self.d_out, dtype=dtype, device=device)

    def _graph(self) -> Module:
        hidden = tuple(Dense(self.width, self.width, self.activation)
                       for _ in range(self.depth - 1))
        return Sequential((Dense(self.d_in, self.width, self.activation),
                           *hidden, Dense(self.width, self.d_out, None)))

    def _graph_params(self, p: MLPParams) -> Params:
        hidden = tuple((p.w_hidden[i], p.b_hidden[i])
                       for i in range(p.w_hidden.shape[0]))
        return ((p.w_in, p.b_in), *hidden, (p.w_out, p.b_out))

    def apply(self, params: MLPParams, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(params, x, self.activation)


@dataclass(frozen=True)
class MLP(_Composed):
    """Fully-connected net with arbitrary layer widths.

    ``widths = (d_in, h_1, ..., h_L, d_out)``; params ARE the module
    graph's: a tuple of (w, b) pairs, one per Dense leaf.  Hidden layers are
    activated, the last is linear.
    """

    widths: Tuple[int, ...]
    activation: str = "tanh"

    def __post_init__(self):
        if len(self.widths) < 2:
            raise ValueError("MLP needs at least (d_in, d_out) widths")

    @property
    def d_in(self) -> int:
        return self.widths[0]

    @property
    def d_out(self) -> int:
        return self.widths[-1]

    def _graph(self) -> Module:
        last = len(self.widths) - 2
        return Sequential(tuple(
            Dense(fi, fo, self.activation if i < last else None)
            for i, (fi, fo) in enumerate(zip(self.widths[:-1],
                                             self.widths[1:]))))

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        return self._graph().init(generator, dtype, device)


# ---------------------------------------------------------------------------
# ResidualMLP: skip connections (jet addition is exact)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ResidualMLP(_Composed):
    """``h_0 = act(W_in x + b_in)``; ``h_j = h_{j-1} + act(W_j h_{j-1} + b_j)``
    for ``depth`` blocks; linear readout.  The graph is Dense ->
    Residual(Dense) x depth -> Dense; residual adds are coefficient-wise on
    the jet, so the derivative cost matches the plain MLP layer for layer.
    Under ``impl="cuda"`` every Dense runs the fused kernel; the adds stay
    jet algebra."""

    d_in: int
    width: int
    depth: int
    d_out: int
    activation: str = "tanh"

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        def zeros(n):
            return torch.zeros((n,), dtype=dtype, device=resolve_device(device))
        return {
            "w_in": xavier_uniform(generator, self.d_in, self.width, dtype, device),
            "b_in": zeros(self.width),
            "blocks": tuple(
                (xavier_uniform(generator, self.width, self.width, dtype, device),
                 zeros(self.width)) for _ in range(self.depth)),
            "w_out": xavier_uniform(generator, self.width, self.d_out, dtype, device),
            "b_out": zeros(self.d_out),
        }

    def _graph(self) -> Module:
        blocks = tuple(Residual(Dense(self.width, self.width, self.activation))
                       for _ in range(self.depth))
        return Sequential((Dense(self.d_in, self.width, self.activation),
                           *blocks, Dense(self.width, self.d_out, None)))

    def _graph_params(self, p: Params) -> Params:
        return ((p["w_in"], p["b_in"]), *p["blocks"], (p["w_out"], p["b_out"]))


# ---------------------------------------------------------------------------
# FourierFeatureMLP: random-feature embedding against spectral bias
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FourierFeatureMLP(_Composed):
    """``gamma(x) = [sin(2pi B x), cos(2pi B x)]`` with fixed Gaussian
    ``B ~ N(0, scale^2)`` of shape (d_in, n_features), then an MLP trunk on
    the 2 n_features embedding (Tancik et al. 2020).  The graph is
    FourierFeatures -> Dense stack; B is excluded from gradients and the
    embedding jet is exact."""

    d_in: int
    width: int
    depth: int
    d_out: int
    n_features: int = 16
    feature_scale: float = 1.0
    activation: str = "tanh"

    def _trunk(self) -> MLP:
        widths = (2 * self.n_features,) + (self.width,) * self.depth + (self.d_out,)
        return MLP(widths, self.activation)

    def _embed(self) -> FourierFeatures:
        return FourierFeatures(self.d_in, self.n_features, self.feature_scale)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        return {"B": self._embed().init(generator, dtype, device),
                "mlp": self._trunk().init(generator, dtype, device)}

    def _graph(self) -> Module:
        return Sequential((self._embed(), *self._trunk()._graph().modules))

    def _graph_params(self, p: Params) -> Params:
        return (p["B"], *p["mlp"])


# ---------------------------------------------------------------------------
# Transformer: pre-norm self-attention trunk over coordinate tokens
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Transformer(_Composed):
    """Attention PINN trunk: each input coordinate becomes a token
    (:class:`CoordinateEmbedding`, whose per-coordinate rows double as
    learned positional encodings), ``depth`` pre-norm blocks of
    ``Residual(RMSNorm -> SelfAttention)`` then ``Residual(RMSNorm ->
    MLPBlock)`` mix the tokens, and a final RMSNorm -> mean token pool ->
    linear head reads out ``d_out`` components.  Params are the module
    graph's native tuple.

    Under ``impl="cuda"`` one jet forward launches, per block, the q/k/v
    and MLP dense kernels (5), the flash-jet attention kernel (1) and the
    fused RMSNorm kernel (2), plus the final RMSNorm and the head's dense
    kernel.
    """

    d_in: int
    width: int               # token embedding dim (d_model)
    depth: int               # number of attention + MLP block pairs
    d_out: int
    n_heads: int = 2
    mlp_ratio: int = 2       # feed-forward hidden dim = mlp_ratio * width
    activation: str = "tanh"
    mask: Any = None         # None | "causal" | ("local", window)

    def __post_init__(self):
        if self.width % self.n_heads:
            raise ValueError(f"width={self.width} not divisible by "
                             f"n_heads={self.n_heads}")
        # validate + canonicalize once here: configs pass lists, the
        # dataclass must stay hashable
        probe = SelfAttention(self.width, self.n_heads, self.mask)
        object.__setattr__(self, "mask", probe.mask)

    def _graph(self) -> Module:
        mods = [CoordinateEmbedding(self.d_in, self.width)]
        for _ in range(self.depth):
            mods.append(Residual(Sequential((
                RMSNorm(self.width),
                SelfAttention(self.width, self.n_heads, self.mask)))))
            mods.append(Residual(Sequential((
                RMSNorm(self.width),
                MLPBlock(self.width, self.mlp_ratio * self.width,
                         self.activation)))))
        mods += [RMSNorm(self.width), TokenPool(),
                 Dense(self.width, self.d_out, None)]
        return Sequential(tuple(mods))

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        return self._graph().init(generator, dtype, device)


# ---------------------------------------------------------------------------
# registry: named factories for configs / CLIs
# ---------------------------------------------------------------------------

NetworkFactory = Callable[..., Network]

_NETWORKS: Dict[str, NetworkFactory] = {}


def register_network(name: str, factory: NetworkFactory) -> None:
    if name in _NETWORKS:
        raise ValueError(f"network {name!r} already registered")
    _NETWORKS[name] = factory


def network_names() -> Tuple[str, ...]:
    return tuple(sorted(_NETWORKS))


def make_network(kind: str, *, d_in: int, d_out: int, width: int, depth: int,
                 activation: str = "tanh", **kwargs) -> Network:
    """Build a registered network from the uniform (width, depth) vocabulary
    used by configs and CLIs; extra kwargs go to the factory."""
    if kind not in _NETWORKS:
        raise KeyError(f"unknown network {kind!r}; known: {network_names()}")
    return _NETWORKS[kind](d_in=d_in, d_out=d_out, width=width, depth=depth,
                           activation=activation, **kwargs)


register_network("dense", DenseMLP)
register_network("mlp", lambda *, d_in, d_out, width, depth, activation="tanh",
                 **kw: MLP((d_in,) + (width,) * depth + (d_out,), activation))
register_network("residual", ResidualMLP)
register_network("fourier", FourierFeatureMLP)
register_network("transformer", Transformer)
