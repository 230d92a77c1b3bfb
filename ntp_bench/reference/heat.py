"""The heat operator by manufactured solution: u_t - nu u_xx = 0 on
(t, x) in [0, 1] x [-pi, pi], nu = 1/2, exact u = exp(-nu t) sin x.
The loss is mean(r^2) + 10 mean((u - u*)^2) over the boundary: on each
face of the box, ``n_bc`` points evenly spaced along the other axis."""

from __future__ import annotations

import math

import torch

from . import tables

NU = 0.5
DOMAIN = ((0.0, 1.0), (-math.pi, math.pi))
W_BC = 10.0


def boundary(n_bc: int, dtype, device) -> torch.Tensor:
    faces = []
    for a in range(2):
        other = 1 - a
        line = torch.linspace(*DOMAIN[other], n_bc, dtype=dtype, device=device)
        for side in DOMAIN[a]:
            pts = torch.empty((n_bc, 2), dtype=dtype, device=device)
            pts[:, other] = line
            pts[:, a] = side
            faces.append(pts)
    return torch.cat(faces)


def exact(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-NU * x[:, 0]) * torch.sin(x[:, 1])


def loss(net, pts: torch.Tensor, *, n_bc: int):
    d = tables.grid(net, pts, 2)                     # (2, 3, N, 1)
    r = d[0, 1, :, 0] - NU * d[1, 2, :, 0]
    xb = boundary(n_bc, pts.dtype, pts.device)
    return torch.mean(r ** 2) + W_BC * torch.mean((net.apply(xb)[:, 0] - exact(xb)) ** 2)
