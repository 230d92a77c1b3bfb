"""Self-similar Burgers profiles (paper section IV-C): equation, exact
solution, and jet-based residual derivatives.

ODE (paper eq. 7):      R(U, X) = -lam U + ((1+lam) X + U) U' = 0
Implicit solution (8):  X = -U - C U^{1 + 1/lam}
Smooth profiles:        lam = 1/(2k), k = 1, 2, ... (odd, C^inf solutions)

The k-th profile is found by constraining lam to [1/(2k+1), 1/(2k-1)] and
penalizing |d^n/dX^n R| near the origin with n = 2k+1 -- non-smooth profiles
in that window have a discontinuity there by order 2k+1, so the penalty gives
gradient signal pushing lam to 1/(2k).  Computing d^n R needs n+1 network
derivatives: the paper's motivating workload for n-TangentProp.

Under ``impl="cuda"`` the u-jet runs the fused ``jet_dense`` kernel, whose
template takes orders up to 8.  ``residual_jet`` pushes the u-jet to order
``order + 1``, so the origin term of profile k (order 2k+1) needs order
2k+2: k = 3 is the largest profile the kernels serve (order 8, nine
coefficients), and larger k raises a ``ValueError`` there.
"""

from __future__ import annotations

import torch
import numpy as np

from repro_torch.core import jet as J
from repro_torch.core.ntp import MLPParams, mlp_apply, ntp_forward


def profile_lambda(k: int) -> float:
    return 1.0 / (2 * k)


def lambda_window(k: int) -> tuple[float, float]:
    return 1.0 / (2 * k + 1), 1.0 / (2 * k - 1)


def smoothness_order(k: int) -> int:
    """Derivative order of R penalized at the origin (paper: 2k+1)."""
    return 2 * k + 1


# ---------------------------------------------------------------------------
# exact solution (oracle for accuracy reporting; C = 1 normalization)
# ---------------------------------------------------------------------------

def exact_profile(x: np.ndarray, k: int, c: float = 1.0,
                  tol: float = 1e-13, iters: int = 200) -> np.ndarray:
    """Invert X = -U - c U^(2k+1) by bisection (X monotone decreasing in U)."""
    p = 2 * k + 1
    x = np.asarray(x, np.float64)
    # bracket: U in [-Umax, Umax] with Umax solving Umax + c Umax^p = max|X|
    xm = float(np.max(np.abs(x))) + 1.0
    hi = max(xm, xm ** (1.0 / p))
    lo_all = np.full_like(x, -hi)
    hi_all = np.full_like(x, hi)

    def f(u):
        return -u - c * u ** p - x  # f is decreasing in u

    for _ in range(iters):
        mid = 0.5 * (lo_all + hi_all)
        val = f(mid)
        lo_all = np.where(val > 0, mid, lo_all)   # f>0 -> root is above mid
        hi_all = np.where(val > 0, hi_all, mid)
        if np.max(hi_all - lo_all) < tol:
            break
    return 0.5 * (lo_all + hi_all)


# ---------------------------------------------------------------------------
# residual jets (n-TangentProp engine)
# ---------------------------------------------------------------------------

def jet_derivative(j: J.Jet) -> J.Jet:
    """d/dt of a jet: coeffs'_k = (k+1) c_{k+1} (order drops by one)."""
    n = j.order
    ks = torch.arange(1, n + 1, dtype=j.coeffs.dtype, device=j.coeffs.device)
    return J.Jet(j.coeffs[1:] * ks.reshape((-1,) + (1,) * len(j.shape)))


def residual_jet(params: MLPParams, lam, x: torch.Tensor, order: int,
                 activation: str = "tanh", impl: str = "torch") -> J.Jet:
    """Jet of R along X at each collocation point; R-jet order = ``order``.

    Needs the u-jet to order+1 (R contains U').  One n-TangentProp pass;
    ``impl="cuda"`` runs it through the fused dense kernel."""
    u = ntp_forward(params, x, order + 1, activation=activation,
                    impl=impl)                             # (order+2, N, 1)
    up = jet_derivative(u)                                 # order+1
    u = J.Jet(u.coeffs[:order + 1])                        # truncate to order
    up = J.Jet(up.coeffs[:order + 1])
    xj = J.seed(x, torch.ones_like(x), order)
    adv = J.add(J.scale(xj, 1.0 + lam), u)                 # (1+lam) X + U
    return J.add(J.scale(u, -lam), J.mul(adv, up))


def residual_derivs_autodiff(params: MLPParams, lam, x: torch.Tensor,
                             order: int, activation: str = "tanh") -> torch.Tensor:
    """Baseline: same quantities via nested autodiff (O(M^n) graph).

    Returns (order+1, N, 1) raw derivatives of R, matching
    J.derivatives(residual_jet(...))."""
    from torch.func import grad, vmap

    def u_fn(xs):
        return mlp_apply(params, xs[None, :], activation)[0, 0]

    def r_fn(xs):
        u = u_fn(xs)
        up = grad(u_fn)(xs)[0]
        return -lam * u + ((1.0 + lam) * xs[0] + u) * up

    def all_derivs(xi):
        one = torch.ones((1,), dtype=xi.dtype, device=xi.device)
        outs, h = [], (lambda t: r_fn(xi + one * t))
        for _ in range(order + 1):
            outs.append(h)
            h = grad(h)
        t0 = torch.zeros((), dtype=xi.dtype, device=xi.device)
        return torch.stack([o(t0) for o in outs])

    return vmap(all_derivs)(x).T[..., None]
