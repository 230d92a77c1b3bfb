"""The self-similar Burgers objective (paper section IV-C, eq. 7-8).

R(U, X) = -lam U + ((1 + lam) X + U) U' along X; lam = lo + (hi - lo)
sigmoid(lam_raw) on the window [1/(2k+1), 1/(2k-1)].  The loss is
  w_r mean R^2 + w_s mean (R')^2      on the domain points
+ w_o mean (d^{2k+1} R / dX^{2k+1})^2 on the origin cluster
+ w_b (U(0)^2 + (U'(0) + 1)^2 + mean (U(+-L) - U*(+-L))^2)
with U* the C = 1 profile X = -U - U^{2k+1}, and the weights
(w_r, w_s, w_o, w_b) = (1, 0.1, 1e-3, 10)."""

from __future__ import annotations

import numpy as np
import torch

from . import taylor as T

WEIGHTS = (1.0, 0.1, 1.0e-3, 10.0)


def profile(x: float, k: int) -> float:
    """U*(x): the root of U + U^{2k+1} = -x, by Newton's method."""
    p = 2 * k + 1
    u = -np.sign(x) * min(abs(x), abs(x) ** (1.0 / p))
    for _ in range(100):
        f = u + u ** p + x
        u_new = u - f / (1.0 + p * u ** (p - 1))
        if u_new == u:
            break
        u = u_new
    return float(u)


def residual_derivs(net, lam, x: torch.Tensor, order: int) -> torch.Tensor:
    """(order+1, N, 1): d^k R / dX^k for k <= order."""
    u = net.jet(T.seed(x, torch.ones_like(x), order + 1))
    ks = torch.arange(1, order + 2, dtype=x.dtype, device=x.device).reshape(-1, 1, 1)
    up = u[1:] * ks                                    # the jet of U'
    u = u[:order + 1]
    xj = T.seed(x, torch.ones_like(x), order)
    return T.derivatives(-lam * u + T.mul((1.0 + lam) * xj + u, up))


def loss(net, lam_raw, pts, origin_pts, *, k: int, domain: float):
    lo, hi = 1.0 / (2 * k + 1), 1.0 / (2 * k - 1)
    lam = lo + (hi - lo) * torch.sigmoid(lam_raw)
    order = 2 * k + 1
    r_dom = residual_derivs(net, lam, pts, 1)
    r_org = residual_derivs(net, lam, origin_pts, order)
    x0 = pts.new_zeros((1, 1))
    u0 = T.derivatives(net.jet(T.seed(x0, torch.ones_like(x0), 1)))
    xb = torch.tensor([[-domain], [domain]], dtype=pts.dtype, device=pts.device)
    tb = torch.tensor([profile(-domain, k), profile(domain, k)], dtype=pts.dtype,
                      device=pts.device)
    l_bc = (u0[0, 0, 0] ** 2 + (u0[1, 0, 0] + 1.0) ** 2
            + torch.mean((net.apply(xb)[:, 0] - tb) ** 2))
    wr, ws, wo, wb = WEIGHTS
    return (wr * torch.mean(r_dom[0] ** 2) + ws * torch.mean(r_dom[1] ** 2)
            + wo * torch.mean(r_org[order] ** 2) + wb * l_bc)
