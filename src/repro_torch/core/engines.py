"""Derivative engines: one surface over every way the port computes
higher-order input derivatives of a network.

An engine answers three questions about any
:class:`repro_torch.core.network.Network`:

* ``derivs(net, params, x, order, tangent=None)`` -- raw directional
  derivatives ``d^k/dt^k f(x + t v)`` at t=0, stacked (order+1, N, d_out);
* ``grid(net, params, x, order)`` -- pure derivatives along every coordinate
  axis, (d_in, order+1, N, d_out), with the direction axis folded into the
  batch so the whole grid is ONE forward (one kernel launch per layer);
* ``cross(net, params, x, axes)`` -- the mixed partial
  ``d^m f / dx_{a_1}..dx_{a_m}``, (N, d_out), by polarization of 2^m
  directional derivatives.

=====================  =====================================================
``NTPEngine(impl)``    the paper's quasilinear jet forward (Algorithm 1);
                       ``impl="torch"`` eager or ``impl="cuda"`` kernels
``AutodiffEngine()``   nested ``torch.func`` towers, the O(M^n) baseline
``JetEngine()``        Taylor mode at the level of torch operations
                       (:mod:`repro_torch.core.taylor`), an oracle
                       independent of the layer-level jet algebra
=====================  =====================================================

Spec strings have a canonical identity (:class:`EngineSpec`): ``"ntp"`` ==
``"ntp/torch"``, ``"ntp/cuda"``, ``"autodiff"``, ``"jet"`` == ``"jax-jet"``
== ``"jaxjet"`` (the reference's spellings of its Taylor-mode oracle).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch

from . import jet as J
from . import taylor as T
from .network import Network

# accepted alternate spellings -> canonical engine name
_SPEC_ALIASES = {"jax-jet": "jet", "jaxjet": "jet"}

# engine name -> implementation variants (None = no /impl suffix allowed)
_ENGINE_IMPLS = {"ntp": ("torch", "cuda"), "autodiff": None, "jet": None}


@dataclass(frozen=True)
class EngineSpec:
    """Typed, canonical identity of an engine configuration.

    ``parse`` accepts a spec string (``"ntp"``, ``"ntp/torch"``,
    ``"ntp/cuda"``, ``"autodiff"``, ``"jet"`` and its ``"jax-jet"`` /
    ``"jaxjet"`` aliases), an :class:`EngineSpec`, or a
    :class:`DerivativeEngine`; ``"ntp"`` and ``"ntp/torch"`` are the SAME
    value.  ``str(EngineSpec.parse(s))`` is the canonical string every
    spec-keyed surface uses (the serving cache key).  Round-trip law:
    ``EngineSpec.parse(str(spec)) == spec``.
    """

    name: str
    impl: str | None = None

    def __post_init__(self):
        if self.name not in _ENGINE_IMPLS:
            raise ValueError(f"unknown engine {self.name!r}; want one of "
                             f"{sorted(_ENGINE_IMPLS)}")
        impls = _ENGINE_IMPLS[self.name]
        if impls is None:
            if self.impl is not None:
                raise ValueError(f"engine {self.name!r} takes no /impl "
                                 f"suffix, got {self.impl!r}")
        else:
            impl = self.impl if self.impl is not None else impls[0]
            if impl not in impls:
                raise ValueError(f"unknown impl {impl!r} for engine "
                                 f"{self.name!r} (want one of {impls})")
            object.__setattr__(self, "impl", impl)

    @staticmethod
    def parse(spec: "str | EngineSpec | DerivativeEngine") -> "EngineSpec":
        if isinstance(spec, EngineSpec):
            return spec
        if isinstance(spec, DerivativeEngine):
            return EngineSpec.parse(spec.spec)
        name, _, impl = str(spec).strip().lower().partition("/")
        name = _SPEC_ALIASES.get(name, name)
        try:
            return EngineSpec(name, impl or None)
        except ValueError as e:
            raise ValueError(f"bad engine spec {spec!r}: {e}") from None

    def __str__(self) -> str:
        default = (_ENGINE_IMPLS[self.name] or (None,))[0]
        if self.impl is None or self.impl == default:
            return self.name
        return f"{self.name}/{self.impl}"

    def build(self) -> "DerivativeEngine":
        """Instantiate the engine this spec names."""
        if self.name == "ntp":
            return NTPEngine(self.impl)
        if self.name == "autodiff":
            return AutodiffEngine()
        return JetEngine()


class DerivativeEngine:
    """Base class: implement ``derivs``, inherit ``grid``/``cross``."""

    def derivs(self, net: Network, params, x: torch.Tensor, order: int,
               tangent: torch.Tensor | None = None) -> torch.Tensor:
        """Raw directional derivatives (order+1, N, d_out) along ``tangent``
        (defaults to ones)."""
        raise NotImplementedError

    @property
    def spec(self) -> str:
        """The string this engine round-trips through :meth:`from_spec`."""
        raise NotImplementedError

    def _batched_directional(self, net: Network, params, x: torch.Tensor,
                             dirs: torch.Tensor, order: int) -> torch.Tensor:
        """(n_dirs, order+1, N, d_out): derivatives along each row of ``dirs``,
        with the direction axis folded into the batch -- one large forward.
        Points are tiled (``repeat``) and directions repeated element-wise
        (``repeat_interleave``), so row ``i * N + j`` is point j along
        direction i."""
        n_dirs, batch = dirs.shape[0], x.shape[0]
        xt = x.repeat(n_dirs, 1)
        vt = dirs.repeat_interleave(batch, dim=0)
        d = self.derivs(net, params, xt, order, vt)
        return d.reshape((order + 1, n_dirs, batch, -1)).movedim(1, 0)

    def grid(self, net: Network, params, x: torch.Tensor,
             order: int) -> torch.Tensor:
        """Pure derivatives along every coordinate axis:
        (d_in, order+1, N, d_out)."""
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        return self._batched_directional(net, params, x, eye, order)

    def cross(self, net: Network, params, x: torch.Tensor,
              axes: Sequence[int]) -> torch.Tensor:
        """Mixed partial ``d^m f / dx_{axes[0]} ... dx_{axes[m-1]}``, (N, d_out),
        via the polarization identity

            D_{v_1..v_m} f = 1/(2^m m!) sum_{eps in {+-1}^m}
                             (prod_k eps_k) D^m_{sum_k eps_k v_k} f

        with ``v_k = e_{axes[k]}``.  Repeated axes are allowed."""
        m, d = len(axes), x.shape[-1]
        if m == 0:
            raise ValueError("axes must name at least one differentiation axis")
        if any(a < 0 or a >= d for a in axes):
            raise ValueError(f"axes {tuple(axes)} out of range for d_in={d}")
        # row i of signs is itertools.product((1.0, -1.0), repeat=m)[i]: bit
        # m-1-k of i picks the sign of axis k.  Built on the device, since a
        # host-made tensor would be a blocking copy on every call.
        shifts = torch.arange(m - 1, -1, -1, device=x.device)
        bits = (torch.arange(2 ** m, device=x.device)[:, None] >> shifts) & 1
        signs = 1.0 - 2.0 * bits.to(x.dtype)                               # (2^m, m)
        dirs = x.new_zeros((2 ** m, d))                                    # signs @ e_axes
        for k, a in enumerate(axes):
            dirs[:, a] += signs[:, k]
        derivs = self._batched_directional(net, params, x, dirs, m)
        coefs = torch.prod(signs, dim=1)                                   # (2^m,)
        top = torch.tensordot(coefs, derivs[:, m], dims=1)                 # (N, d_out)
        return top / (2.0 ** m * math.factorial(m))

    @staticmethod
    def from_spec(spec: "str | DerivativeEngine") -> "DerivativeEngine":
        """``"ntp"`` | ``"ntp/cuda"`` | ``"autodiff"`` | ``"jet"`` -> engine.
        Engine instances pass through unchanged."""
        if isinstance(spec, DerivativeEngine):
            return spec
        return EngineSpec.parse(spec).build()

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.spec!r})"


@dataclass(frozen=True)
class NTPEngine(DerivativeEngine):
    """Quasilinear Taylor-jet forward (paper Algorithm 1, generalized to any
    jet-traceable network)."""

    impl: str = "torch"

    def __post_init__(self):
        if self.impl not in _ENGINE_IMPLS["ntp"]:
            raise ValueError(f"unknown impl {self.impl!r} "
                             "(want 'torch' or 'cuda')")

    @property
    def spec(self) -> str:
        return "ntp" if self.impl == "torch" else f"ntp/{self.impl}"

    def derivs(self, net: Network, params, x: torch.Tensor, order: int,
               tangent: torch.Tensor | None = None) -> torch.Tensor:
        if order == 0:
            return net.apply(params, x)[None]
        jet = net.jet_apply(params, J.seed(x, tangent, order), impl=self.impl)
        return J.derivatives(jet)


@dataclass(frozen=True)
class AutodiffEngine(DerivativeEngine):
    """Nested autodiff towers over ``net.apply`` -- the baseline whose graph
    grows O(M^order).  Scalar outputs nest ``torch.func.grad``; vector
    outputs nest forward-mode ``torch.func.jacfwd``; points are batched with
    ``torch.func.vmap``."""

    @property
    def spec(self) -> str:
        return "autodiff"

    def derivs(self, net: Network, params, x: torch.Tensor, order: int,
               tangent: torch.Tensor | None = None) -> torch.Tensor:
        from torch.func import grad, jacfwd, vmap

        if tangent is None:
            tangent = torch.ones_like(x)
        scalar = net.d_out == 1

        def along(xi, vi):
            if scalar:
                def g(t):
                    return net.apply(params, (xi + t * vi)[None, :])[0, 0]
                lift = grad
            else:
                def g(t):
                    return net.apply(params, (xi + t * vi)[None, :])[0]
                lift = jacfwd
            outs, h = [], g
            for _ in range(order + 1):
                outs.append(h)
                h = lift(h)
            t0 = torch.zeros((), dtype=x.dtype, device=x.device)
            return torch.stack([torch.atleast_1d(o(t0)) for o in outs])

        return vmap(along)(x, tangent).movedim(0, 1)


@dataclass(frozen=True)
class JetEngine(DerivativeEngine):
    """Taylor mode through ``net.apply``'s torch operations
    (:mod:`repro_torch.core.taylor`), the counterpart of the reference's
    ``JaxJetEngine``.  Quasilinear like NTP but independent of it (rules per
    torch operation against the layer-level jet algebra), so agreement
    between the two certifies both; any network whose ``apply`` uses only
    operations with a Taylor rule runs, on the device of its inputs."""

    @property
    def spec(self) -> str:
        return "jet"

    def derivs(self, net: Network, params, x: torch.Tensor, order: int,
               tangent: torch.Tensor | None = None) -> torch.Tensor:
        if order == 0:
            return net.apply(params, x)[None]
        return T.taylor_derivatives(lambda xx: net.apply(params, xx), x, order, tangent)
