"""Collocation-point samplers for PINN training.

Where the reference takes a ``jax.random`` key, these take a
``torch.Generator``.  Draws are made on the CPU generator and then moved to
``device`` (the CUDA device by default), so one seed gives the same points
on every device.  The two frameworks' generators give different numbers
from one seed: the trainers accept injected points for a step-for-step
comparison (``repro_torch.pinn.trainer``).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def _uniform(generator: torch.Generator, shape, dtype, lo, hi, device):
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return (lo + (hi - lo) * u).to(resolve_device(device))


def uniform_grid(lo: float, hi: float, n: int, dtype=torch.float64,
                 device=None) -> torch.Tensor:
    return torch.linspace(lo, hi, n, dtype=dtype,
                          device=resolve_device(device))[:, None]


def random_points(generator: torch.Generator, lo: float, hi: float, n: int,
                  dtype=torch.float64, device=None) -> torch.Tensor:
    return _uniform(generator, (n, 1), dtype, lo, hi, device)


def origin_cluster(generator: torch.Generator, radius: float, n: int,
                   dtype=torch.float64, device=None) -> torch.Tensor:
    """Points concentrated near x=0 where the high-order smoothness loss acts."""
    return _uniform(generator, (n, 1), dtype, -radius, radius, device)


def resample(generator: torch.Generator, lo: float, hi: float, n_domain: int,
             n_origin: int, origin_radius: float, dtype=torch.float64,
             device=None):
    return (random_points(generator, lo, hi, n_domain, dtype, device),
            origin_cluster(generator, origin_radius, n_origin, dtype, device))


# ---------------------------------------------------------------------------
# d-dimensional boxes (the operator subsystem's collocation surface)
# ---------------------------------------------------------------------------

Domain = tuple  # ((lo, hi), ...) -- one interval per input axis


def sample_box(generator: torch.Generator, domain: Domain, n: int,
               dtype=torch.float64, device=None) -> torch.Tensor:
    """(n, d) uniform interior collocation points in a box domain."""
    lo = torch.tensor([b[0] for b in domain], dtype=dtype)
    hi = torch.tensor([b[1] for b in domain], dtype=dtype)
    u = torch.rand((n, len(domain)), generator=generator, dtype=dtype)
    return (lo + (hi - lo) * u).to(resolve_device(device))


def boundary_grid(domain: Domain, n_per_face: int, dtype=torch.float64,
                  device=None) -> torch.Tensor:
    """Deterministic points on every face of the box (both endpoints of each
    axis).  For time-dependent PDEs trained by manufactured solutions the
    t=0 face supplies the initial condition and the other faces Dirichlet
    data -- supervising on the t=T face too is harmless extra data."""
    device = resolve_device(device)
    d = len(domain)
    if d == 1:
        return torch.tensor([[domain[0][0]], [domain[0][1]]], dtype=dtype,
                            device=device)
    n_side = max(2, int(round(n_per_face ** (1.0 / (d - 1)))))
    faces = []
    for a in range(d):
        others = [i for i in range(d) if i != a]
        axes = [torch.linspace(domain[i][0], domain[i][1], n_side, dtype=dtype)
                for i in others]
        mesh = torch.meshgrid(*axes, indexing="ij")
        rest = torch.stack([m.reshape(-1) for m in mesh], dim=-1)
        for side in domain[a]:
            pts = torch.zeros((rest.shape[0], d), dtype=dtype)
            pts[:, others] = rest
            pts[:, a] = side
            faces.append(pts)
    return torch.cat(faces).to(device)


def eval_grid(domain: Domain, n_per_axis: int, dtype=torch.float64,
              device=None) -> torch.Tensor:
    """Dense tensor-product grid over the box, for accuracy reporting."""
    axes = [torch.linspace(lo, hi, n_per_axis, dtype=dtype) for lo, hi in domain]
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=-1).to(
        resolve_device(device))
