"""Derivative tables of a reference network: ``grid`` (the pure derivatives
along each input axis through an order) and ``cross`` (one mixed partial,
by the polarization identity
D_{v_1..v_m} f = 1/(2^m m!) sum_{eps in {+-1}^m} (prod eps) D^m_{sum eps_k v_k} f)."""

from __future__ import annotations

import itertools
import math

import torch

from . import taylor as T


def directional(net, x: torch.Tensor, v: torch.Tensor, order: int) -> torch.Tensor:
    """(order+1, N, d_out): d^k/dt^k f(x + t v) at t = 0."""
    return T.derivatives(net.jet(T.seed(x, v.expand_as(x), order)))


def grid(net, x: torch.Tensor, order: int) -> torch.Tensor:
    """(d_in, order+1, N, d_out)."""
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    return torch.stack([directional(net, x, eye[a], order) for a in range(x.shape[1])])


def cross(net, x: torch.Tensor, axes) -> torch.Tensor:
    """(N, d_out): d^m f / dx_{axes[0]} .. dx_{axes[m-1]}."""
    m = len(axes)
    total = 0
    for signs in itertools.product((1.0, -1.0), repeat=m):
        v = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
        for s, a in zip(signs, axes):
            v[a] += s
        total = total + math.prod(signs) * directional(net, x, v, m)[m]
    return total / (2.0 ** m * math.factorial(m))
