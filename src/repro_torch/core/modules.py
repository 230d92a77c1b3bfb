"""Compositional jet-modules: the blocks every Network is built from.

A :class:`Module` is the smallest jet-traceable unit -- ``init`` / ``apply``
/ ``jet_apply`` with exactly the Network contract
(``repro_torch.core.network``):

* **leaves** own parameters and the jet rules for one operation --
  :class:`Dense` (with the fused ``jet_dense`` kernel path) and
  :class:`Activation`;
* **combinators** own structure only -- :class:`Sequential` (params are a
  tuple, one entry per child, drawn from the generator in child order) and
  :class:`Residual` (``x + inner(x)``; jet addition is exact).

``impl="cuda"`` routes every Dense contraction through
``repro_torch.kernels.ops.jet_dense``, fusing the activation into the
kernel's epilogue when ``ops.epilogues()`` marks the name ``ACTIVATION``;
anything unfused runs the jet algebra, so a module mixes kernel and eager
paths freely.  The transformer leaves (RMSNorm, SelfAttention, ...) come
with the transformer slice.
"""

from __future__ import annotations

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
    """Can the dense kernel run ``name`` in its Faa di Bruno epilogue?"""
    from repro_torch.kernels import ops as kops
    return kops.epilogues().get(name) is kops.EpilogueKind.ACTIVATION


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
    ("sequential", Sequential),
    ("residual", Residual),
):
    register_module(_name, _factory)
