"""Baselines the paper compares against, plus an independent oracle.

* ``nested_autodiff``       -- the standard PINN practice the paper
                               benchmarks: n nested reverse-mode sweeps
                               (O(M^n) graph).
* ``nested_jacfwd``         -- forward-over-forward nesting; same asymptotic
                               blow-up, often faster constants.
* ``taylor_jet_derivatives`` -- Taylor mode through the torch operations
                               (:mod:`repro_torch.core.taylor`), the
                               counterpart of the reference's
                               ``jax_jet_derivatives``: a quasilinear
                               implementation independent of ours, used as a
                               correctness oracle.

The first two are built on ``torch.func``.
"""

from __future__ import annotations

from typing import Callable

import torch

from .ntp import MLPParams, mlp_apply


def _scalar_fn(params: MLPParams, activation: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """x (d_in,) -> the sum of the output coordinates (as the paper's PINN
    nets have d_out == 1, this is just u(x))."""

    def f(x):
        return mlp_apply(params, x[None, :], activation)[0].sum()

    return f


def _towers(params: MLPParams, x: torch.Tensor, order: int,
            tangent: torch.Tensor | None, activation: str,
            lift: Callable[[Callable], Callable]) -> torch.Tensor:
    from torch.func import vmap

    if tangent is None:
        tangent = torch.ones_like(x)
    f = _scalar_fn(params, activation)

    def along(xi, vi):
        outs, h = [], (lambda t: f(xi + t * vi))
        for _ in range(order + 1):
            outs.append(h)
            h = lift(h)
        t0 = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.stack([o(t0) for o in outs])

    return vmap(along)(x, tangent).T[..., None]


def nested_autodiff(params: MLPParams, x: torch.Tensor, order: int,
                    tangent: torch.Tensor | None = None,
                    activation: str = "tanh") -> torch.Tensor:
    """(order+1, batch, 1) directional derivatives via n nested
    ``torch.func.grad``."""
    from torch.func import grad
    return _towers(params, x, order, tangent, activation, grad)


def nested_jacfwd(params: MLPParams, x: torch.Tensor, order: int,
                  tangent: torch.Tensor | None = None,
                  activation: str = "tanh") -> torch.Tensor:
    """Same quantity via nested forward mode (``torch.func.jvp`` towers)."""
    from torch.func import jvp

    def lift(prev):
        return lambda t: jvp(prev, (t,), (torch.ones_like(t),))[1]

    return _towers(params, x, order, tangent, activation, lift)


def taylor_jet_derivatives(params: MLPParams, x: torch.Tensor, order: int,
                           tangent: torch.Tensor | None = None,
                           activation: str = "tanh") -> torch.Tensor:
    """(order+1, batch, d_out) raw derivatives by Taylor mode
    (:func:`repro_torch.core.taylor.taylor_derivatives`) through
    :func:`mlp_apply`."""
    from .taylor import taylor_derivatives
    return taylor_derivatives(lambda xx: mlp_apply(params, xx, activation), x, order,
                              tangent)
