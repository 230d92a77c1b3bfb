"""PINN loss assembly, generic over a differential operator.

``pinn_loss`` is the operator-generic objective: residual MSE over interior
collocation points plus boundary/initial supervision against the operator's
exact solution, generic over the :class:`DerivativeEngine` (``ntp`` eager,
``ntp/cuda`` on the kernels, ``autodiff`` baseline; by object or spec
string), the :class:`Network` (``net=``, required) and the operator's
output rank: scalar PDEs and multi-equation systems (``op.d_out > 1``,
e.g. Gray-Scott) run through the same code path.  The self-similar Burgers
workload keeps its specialized objective (learnable lambda, Sobolev term,
high-order origin smoothness -- paper eq. 1, 2 and appendix A) as
``burgers_pinn_loss``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import torch

from repro_torch.core import jet as J
from repro_torch.core.engines import DerivativeEngine
from repro_torch.core.network import Network
from repro_torch.core.ntp import MLPParams, mlp_apply

from .burgers import exact_profile, residual_derivs_autodiff, residual_jet
from .operators import Operator, build_table, get_operator

@dataclass(frozen=True)
class LossWeights:
    residual: float = 1.0
    sobolev1: float = 0.1     # Q_1 of the Sobolev loss (paper eq. 2, m=1)
    origin: float = 1.0e-3    # high-order smoothness at the origin (L*)
    bc: float = 10.0


# ---------------------------------------------------------------------------
# generic operator objective
# ---------------------------------------------------------------------------

def pinn_loss(params, *, op: Union[Operator, str], pts: torch.Tensor,
              bc_pts: torch.Tensor, bc_vals: torch.Tensor, net: Network,
              weights: LossWeights = LossWeights(),
              engine: Union[str, DerivativeEngine] = "ntp",
              mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Operator-generic PINN objective: w_r ||R[u]||^2 + w_bc ||u - u*||^2_bd.

    ``bc_vals`` is the exact solution on ``bc_pts`` -- (N,) for scalar
    operators, (N, d_out) for systems
    (:func:`repro_torch.pinn.operators.exact_values` normalizes the shape).
    For a multi-equation system the residual term averages the squares of
    every equation and the boundary term supervises every output component.
    ``mesh`` (a :class:`repro_torch.parallel.DataMesh`, on every rank of its
    process group) shards the residual's grid/cross calls over the ranks
    through :class:`repro_torch.parallel.ShardedEngine`: the same loss on
    every rank, its collocation batch split across them, and under autograd
    the whole batch's gradient on every rank."""
    if isinstance(op, str):
        op = get_operator(op)
    eng = DerivativeEngine.from_spec(engine)
    if mesh is not None:
        from repro_torch.parallel.jet_shard import ShardedEngine
        eng = ShardedEngine(eng, mesh)
    r = op.residual(pts, build_table(net, params, eng, op, pts))
    l_res = torch.mean(r ** 2)
    ub = net.apply(params, bc_pts)                       # (Nb, d_out)
    bv = torch.as_tensor(bc_vals)
    if bv.ndim == 1:
        bv = bv[:, None]
    if bv.shape != ub.shape:
        raise ValueError(
            f"bc_vals shape {tuple(bv.shape)} does not match the network's "
            f"boundary output {tuple(ub.shape)}; systems need one column per "
            f"component")
    l_bc = torch.mean((ub - bv) ** 2)
    loss = weights.residual * l_res + weights.bc * l_bc
    return loss, {"residual": l_res, "bc": l_bc}


# ---------------------------------------------------------------------------
# the self-similar Burgers objective (paper section IV-C)
# ---------------------------------------------------------------------------

def _burgers_engine(engine: Union[str, DerivativeEngine]) -> Tuple[str, str]:
    """Normalize a spec string or engine instance to the specialized Burgers
    pipeline's ("ntp"|"autodiff", impl) pair."""
    from repro_torch.core.engines import AutodiffEngine, NTPEngine
    eng = DerivativeEngine.from_spec(engine)
    if isinstance(eng, NTPEngine):
        return "ntp", eng.impl
    if isinstance(eng, AutodiffEngine):
        return "autodiff", "torch"
    raise ValueError(f"burgers objective supports the ntp and autodiff "
                     f"engines, not {eng.spec!r}")


def bc_targets(k: int, domain: float) -> Tuple[float, float]:
    """U_true(+-L) with the C=1 normalization."""
    import numpy as np
    vals = exact_profile(np.array([-domain, domain]), k)
    return float(vals[0]), float(vals[1])


def burgers_pinn_loss(params: MLPParams, lam_raw: torch.Tensor, *, k: int,
                      pts: torch.Tensor, origin_pts: torch.Tensor,
                      domain: float, order: int, weights: LossWeights,
                      lam_window: Tuple[float, float], engine: str = "ntp",
                      activation: str = "tanh",
                      bc_vals: Tuple[float, float] = None) -> Tuple[torch.Tensor, Dict]:
    """Full self-similar Burgers objective.  ``engine``: a spec string
    ("ntp", "ntp/cuda", "autodiff") or :class:`DerivativeEngine` instance.
    Everything else is identical, so the benchmark isolates the derivative
    engine.  Under ``ntp/cuda`` one evaluation runs three u-jets (domain,
    origin cluster, the U(0) boundary term), each through the fused dense
    kernel once per hidden layer."""
    engine, impl = _burgers_engine(engine)
    lo, hi = lam_window
    lam = lo + (hi - lo) * torch.sigmoid(lam_raw)

    if engine == "ntp":
        # one jet to order 1 on the full domain (residual + Sobolev-1) ...
        r_dom = J.derivatives(residual_jet(params, lam, pts, 1,
                                           activation=activation, impl=impl))
        # ... and one high-order jet on the origin cluster
        r_org = J.derivatives(residual_jet(params, lam, origin_pts, order,
                                           activation=activation, impl=impl))
    else:
        r_dom = residual_derivs_autodiff(params, lam, pts, 1, activation)
        r_org = residual_derivs_autodiff(params, lam, origin_pts, order, activation)

    l_res = torch.mean(r_dom[0] ** 2)
    l_sob = torch.mean(r_dom[1] ** 2)
    l_org = torch.mean(r_org[order] ** 2)

    # boundary conditions: U(0)=0, U'(0)=-1, U(+-L) pinned to the C=1 profile.
    # The constants are filled on the device: a host-made tensor would be a
    # blocking copy on every evaluation.
    x0 = pts.new_zeros((1, 1))
    u0j = J.derivatives(residual_jet_u(params, x0, activation=activation,
                                       impl=impl))
    u0, du0 = u0j[0, 0, 0], u0j[1, 0, 0]
    xb = torch.linspace(-domain, domain, 2, dtype=pts.dtype,
                        device=pts.device)[:, None]
    ub = mlp_apply(params, xb, activation)
    tb = torch.stack([pts.new_full((), v) for v in bc_vals])
    l_bc = u0 ** 2 + (du0 + 1.0) ** 2 + torch.mean((ub[:, 0] - tb) ** 2)

    loss = (weights.residual * l_res + weights.sobolev1 * l_sob +
            weights.origin * l_org + weights.bc * l_bc)
    return loss, {"residual": l_res, "sobolev1": l_sob, "origin": l_org,
                  "bc": l_bc, "lambda": lam}


def residual_jet_u(params: MLPParams, x: torch.Tensor, activation: str = "tanh",
                   impl: str = "torch") -> J.Jet:
    """Order-1 jet of U itself (for the U(0), U'(0) boundary terms)."""
    from repro_torch.core.ntp import ntp_forward
    return ntp_forward(params, x, 1, activation=activation, impl=impl)
