"""Plain PyTorch versions of the CUDA kernels.

These are *independent* straight-line implementations (no CUDA, no core.jet
reuse beyond the static tables) so kernel bugs cannot hide behind a shared
code path.  On the CPU the kernel wrappers run these; on the card
``chip_smoke.py`` holds each kernel against them.
"""

from __future__ import annotations

import torch

from repro_torch.core.activations import sin_taylor_stack

from .bell_tables import fdb_terms, sigmoid_poly_rows, tanh_poly_rows

_POLY_ROWS = {"tanh": tanh_poly_rows, "sigmoid": sigmoid_poly_rows}
_PRIMAL = {"tanh": torch.tanh,
           "sigmoid": lambda a: 0.5 * (torch.tanh(0.5 * a) + 1.0)}


def _taylor_stack(a: torch.Tensor, n: int, activation: str) -> list[torch.Tensor]:
    """[sigma^(m)(a)/m! for m in 0..n] via Horner on the closed-form polys
    (tanh/sigmoid) or core.activations' sin phase cycle."""
    if activation == "sin":
        return list(sin_taylor_stack(a, n))
    u = _PRIMAL[activation](a)
    rows = _POLY_ROWS[activation](n)
    out = []
    for m in range(n + 1):
        row = rows[m]
        acc = torch.full_like(u, row[-1])
        for c in row[-2::-1]:
            acc = acc * u + c
        out.append(acc)
    return out


def act_jet_ref(coeffs: torch.Tensor, activation: str = "tanh") -> torch.Tensor:
    """Faa di Bruno activation jet.  coeffs: (n+1, ...) scaled Taylor coeffs of
    the pre-activation; returns the same-shaped stack for sigma(pre-act)."""
    n = coeffs.shape[0] - 1
    f = _taylor_stack(coeffs[0], n, activation)
    rows = [f[0]]
    for terms in fdb_terms(n):
        acc = torch.zeros_like(coeffs[0])
        for coef, m, powers in terms:
            prod = f[m] * coef
            for j, e in powers:
                for _ in range(e):
                    prod = prod * coeffs[j]
            acc = acc + prod
        rows.append(acc)
    return torch.stack(rows)


def jet_dense_ref(coeffs: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  activation: str | None = "tanh") -> torch.Tensor:
    """Fused layer: (n+1, B, Din) @ (Din, Dout) + bias-on-c0, then the
    activation jet (or identity for the output layer)."""
    z = torch.einsum("nbi,io->nbo", coeffs, w)
    z = torch.cat([z[:1] + b, z[1:]])
    if activation is None:
        return z
    return act_jet_ref(z, activation)
