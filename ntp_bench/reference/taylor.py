"""Taylor-mode arithmetic on stacks of normalized coefficients.

A jet is a tensor (K+1, ...) whose entry k is c_k = (1/k!) d^k/dt^k of a
quantity along a curve t -> x + t v.  Linear maps act on every entry;
products are Cauchy sums; each smooth function follows the recurrence its
own differential equation gives (Griewank and Walther, "Evaluating
Derivatives", ch. 13):

* tanh:  y' = (1 - y^2) z'     ->  k y_k = sum_j j z_j d_{k-j},  d = 1 - y^2
* exp:   y' = y z'             ->  k y_k = sum_j j z_j y_{k-j}
* u^p:   u y' = p u' y         ->  k u_0 y_k = sum_j (p j - (k - j)) u_j y_{k-j}
* a / b: b q = a               ->  q_k = (a_k - sum_{j>=1} b_j q_{k-j}) / b_0
"""

from __future__ import annotations

import math

import torch


def seed(x: torch.Tensor, v: torch.Tensor, order: int) -> torch.Tensor:
    """The jet of t -> x + t v: c_0 = x, c_1 = v, the rest 0."""
    out = torch.zeros((order + 1,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    out[0] = x
    if order >= 1:
        out[1] = v
    return out


def derivatives(c: torch.Tensor) -> torch.Tensor:
    """Raw derivatives k! c_k."""
    f = torch.tensor([float(math.factorial(k)) for k in range(c.shape[0])],
                     dtype=c.dtype, device=c.device)
    return c * f.reshape((-1,) + (1,) * (c.ndim - 1))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([sum(a[i] * b[k - i] for i in range(k + 1))
                        for k in range(a.shape[0])])


def tanh(z: torch.Tensor) -> torch.Tensor:
    y = [torch.tanh(z[0])]
    d = [1 - y[0] * y[0]]
    for k in range(1, z.shape[0]):
        y.append(sum(j * z[j] * d[k - j] for j in range(1, k + 1)) / k)
        d.append(-sum(y[i] * y[k - i] for i in range(k + 1)))
    return torch.stack(y)


def exp(z: torch.Tensor) -> torch.Tensor:
    y = [torch.exp(z[0])]
    for k in range(1, z.shape[0]):
        y.append(sum(j * z[j] * y[k - j] for j in range(1, k + 1)) / k)
    return torch.stack(y)


def power(u: torch.Tensor, p: float) -> torch.Tensor:
    y = [u[0] ** p]
    for k in range(1, u.shape[0]):
        y.append(sum((p * j - (k - j)) * u[j] * y[k - j] for j in range(1, k + 1))
                 / (k * u[0]))
    return torch.stack(y)


def div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    q = []
    for k in range(a.shape[0]):
        q.append((a[k] - sum(b[j] * q[k - j] for j in range(1, k + 1))) / b[0])
    return torch.stack(q)


def linear(c: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w + b on every coefficient; the bias is a constant, so c_0 only."""
    out = c @ w
    if b is None:
        return out
    return torch.cat([out[:1] + b, out[1:]])
