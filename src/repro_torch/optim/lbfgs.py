"""L-BFGS with a strong-Wolfe line search, as the JAX package runs it.

The paper's high-accuracy PINN phase is L-BFGS-dominated and line-search
forward passes are exactly where n-TangentProp wins (paper section IV-C).
Nocedal & Wright (Alg. 6.1 two-loop recursion; Alg. 3.5/3.6 bracket-zoom
line search) on the raveled parameter vector, laid out as the reference's
``ravel_pytree`` lays it out (:func:`repro_torch.tree.ravel`), so the two
histories can be compared entry by entry.  Line-search scalars (the loss,
directional derivatives, step lengths) are Python floats: the search
branches on them on the host, as the reference's does.  This is the
reference's algorithm, not ``torch.optim.LBFGS``.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch

from repro_torch.tree import ravel


class LBFGSResult(NamedTuple):
    params: object
    loss_history: list
    n_evals: int


def _vdot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b))


def _two_loop(grad, s_list, y_list):
    q = grad
    alphas = []
    for s, y in zip(reversed(s_list), reversed(y_list)):
        rho = 1.0 / _vdot(y, s)
        a = rho * _vdot(s, q)
        q = q - a * y
        alphas.append((a, rho))
    if s_list:
        s, y = s_list[-1], y_list[-1]
        gamma = _vdot(s, y) / _vdot(y, y)
    else:
        gamma = 1.0
    r = gamma * q
    for (a, rho), s, y in zip(reversed(alphas), s_list, y_list):
        b = rho * _vdot(y, r)
        r = r + (a - b) * s
    return r


def _wolfe_zoom(phi, lo, hi, f_lo, f0, g0, c1, c2, max_iter=12):
    """Bisection zoom satisfying strong Wolfe."""
    for _ in range(max_iter):
        t = 0.5 * (lo + hi)
        f_t, g_t = phi(t)
        if (f_t > f0 + c1 * t * g0) or (f_t >= f_lo):
            hi = t
        else:
            if abs(g_t) <= -c2 * g0:
                return t, f_t
            if g_t * (hi - lo) >= 0:
                hi = lo
            lo, f_lo = t, f_t
    return t, f_t


def _wolfe_search(phi, f0, g0, c1=1e-4, c2=0.9, t_init=1.0, max_iter=10):
    """Strong-Wolfe line search; phi(t) -> (f, dphi/dt)."""
    t_prev, f_prev = 0.0, f0
    t = t_init
    for i in range(max_iter):
        f_t, g_t = phi(t)
        if (f_t > f0 + c1 * t * g0) or (i > 0 and f_t >= f_prev):
            return _wolfe_zoom(phi, t_prev, t, f_prev, f0, g0, c1, c2)
        if abs(g_t) <= -c2 * g0:
            return t, f_t
        if g_t >= 0:
            return _wolfe_zoom(phi, t, t_prev, f_t, f0, g0, c1, c2)
        t_prev, f_prev = t, f_t
        t = 2.0 * t
    return t, f_t


def lbfgs(value_and_grad: Callable, params, *, steps: int, history: int = 10,
          tol: float = 1e-12, callback: Callable | None = None) -> LBFGSResult:
    """Minimize.  ``value_and_grad(params) -> (loss, grads)``, ``grads`` a
    tree like ``params``."""
    x, unravel = ravel(params)
    x = x.detach()

    n_evals = 0

    def vg(xv):
        nonlocal n_evals
        n_evals += 1
        f, g = value_and_grad(unravel(xv))
        return float(f), ravel(g)[0].detach()

    f, g = vg(x)
    s_list: List = []
    y_list: List = []
    losses = [f]

    for it in range(steps):
        d = -_two_loop(g, s_list, y_list)
        dg = _vdot(g, d)
        if dg >= 0:  # not a descent direction; reset memory
            s_list, y_list = [], []
            d, dg = -g, -_vdot(g, g)

        def phi(t):
            ft, gt = vg(x + t * d)
            return ft, _vdot(gt, d)

        t, f_new = _wolfe_search(phi, f, dg, t_init=1.0 if s_list else
                                 min(1.0, 1.0 / (abs(dg) + 1e-12)))
        x_new = x + t * d
        _, g_new = vg(x_new)

        s, y = x_new - x, g_new - g
        if _vdot(s, y) > 1e-10 * _vdot(y, y):
            s_list.append(s)
            y_list.append(y)
            if len(s_list) > history:
                s_list.pop(0)
                y_list.pop(0)

        x, f, g = x_new, f_new, g_new
        losses.append(f)
        if callback is not None:
            callback(it, f, unravel(x))
        if len(losses) > 2 and abs(losses[-2] - losses[-1]) < tol * max(1.0, abs(losses[-2])):
            break

    return LBFGSResult(unravel(x), losses, n_evals)
