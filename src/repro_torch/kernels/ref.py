"""Plain PyTorch versions of the CUDA kernels.

These are *independent* straight-line implementations (no CUDA, no core.jet
reuse beyond the static tables) so kernel bugs cannot hide behind a shared
code path.  On the CPU the kernel wrappers run these; on the card
``chip_smoke.py`` holds each kernel against them.  Each takes any order.
bfloat16 inputs are computed in float32 and the result rounded to
bfloat16, as the reference promotes them (``promote_types(dtype,
float32)``) and as the kernels do.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.activations import sin_taylor_stack

from .bell_tables import fdb_terms, sigmoid_poly_rows, tanh_poly_rows

_POLY_ROWS = {"tanh": tanh_poly_rows, "sigmoid": sigmoid_poly_rows}
_PRIMAL = {"tanh": torch.tanh,
           "sigmoid": lambda a: 0.5 * (torch.tanh(0.5 * a) + 1.0)}


def _promoted(fn):
    """``fn`` in float32 on bfloat16 tensor arguments, its result rounded
    back to bfloat16."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not any(isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
                   for a in args):
            return fn(*args, **kwargs)
        up = [a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
              else a for a in args]
        return fn(*up, **kwargs).to(torch.bfloat16)
    return wrapper


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


@_promoted
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


@_promoted
def jet_dense_ref(coeffs: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  activation: str | None = "tanh") -> torch.Tensor:
    """Fused layer: (n+1, B, Din) @ (Din, Dout) + bias-on-c0, then the
    activation jet (or identity for the output layer)."""
    z = torch.einsum("nbi,io->nbo", coeffs, w)
    z = torch.cat([z[:1] + b, z[1:]])
    if activation is None:
        return z
    return act_jet_ref(z, activation)


@_promoted
def jet_attention_scores_ref(q: torch.Tensor, k: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """Fused attention-score oracle: (n+1, B, T, D) Q/K coefficient stacks
    -> the softmaxed score jet (n+1, B, Tq, Tk).

    Straight-line: the Cauchy convolution of the score contraction, then the
    softmax exp / sum / div power-series recurrences written out directly
    (no core.jet, no shared kernel body)."""
    n1 = q.shape[0]
    s = [scale * sum(torch.einsum("bqd,bkd->bqk", q[i], k[m - i])
                     for i in range(m + 1)) for m in range(n1)]
    shift = s[0].amax(dim=-1, keepdim=True)
    e = [torch.exp(s[0] - shift)]
    for m in range(1, n1):
        e.append(sum(j * s[j] * e[m - j] for j in range(1, m + 1)) / m)
    tot = [em.sum(dim=-1, keepdim=True) for em in e]
    p = [e[0] / tot[0]]
    for m in range(1, n1):
        p.append((e[m] - sum(tot[j] * p[m - j] for j in range(1, m + 1)))
                 / tot[0])
    return torch.stack(p)


@_promoted
def jet_flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            wo: torch.Tensor, scale: float,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Full attention-block oracle: Q/K/V stacks (n+1, B, H, T, Dh) and the
    output projection ``wo`` (H, Dh, Dm) -> the block output jet
    (n+1, B, T, Dm).

    Straight-line scores -> masked softmax -> value contraction -> output
    projection, all as explicit Cauchy convolutions / power-series
    recurrences (no core.jet, no online rescaling -- the O(T^2)-memory
    computation the tiled kernel must reproduce).  ``mask`` is a dense
    boolean (Tq, Tk) keep-matrix (True = attend); masked ``s_0`` becomes
    -1e30 before the exp recurrence, so masked e-jets vanish."""
    n1 = q.shape[0]
    s = [scale * sum(torch.einsum("bhqd,bhkd->bhqk", q[i], k[m - i])
                     for i in range(m + 1)) for m in range(n1)]
    if mask is not None:
        s[0] = torch.where(mask, s[0], torch.full_like(s[0], -1e30))
    shift = s[0].amax(dim=-1, keepdim=True)
    e = [torch.exp(s[0] - shift)]
    for m in range(1, n1):
        e.append(sum(j * s[j] * e[m - j] for j in range(1, m + 1)) / m)
    tot = [em.sum(dim=-1, keepdim=True) for em in e]
    p = [e[0] / tot[0]]
    for m in range(1, n1):
        p.append((e[m] - sum(tot[j] * p[m - j] for j in range(1, m + 1)))
                 / tot[0])
    o = [sum(torch.einsum("bhqk,bhkd->bhqd", p[i], v[m - i])
             for i in range(m + 1)) for m in range(n1)]
    return torch.stack([torch.einsum("bhqd,hdo->bqo", om, wo) for om in o])


@_promoted
def jet_rms_norm_ref(coeffs: torch.Tensor, gamma: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Fused rms_norm oracle: (n+1, B, W) stack + (W,) gain -> rms_norm jet.

    Straight-line mean-square convolution, binomial-series rsqrt (Miller
    recurrence, r = -1/2, coefficient ``(0.5 j - m)``), normalizing
    convolution, gain."""
    n1 = coeffs.shape[0]
    ms = [sum((coeffs[i] * coeffs[m - i]).mean(dim=-1, keepdim=True)
              for i in range(m + 1)) for m in range(n1)]
    ms[0] = ms[0] + eps
    inv = [1.0 / torch.sqrt(ms[0])]
    for m in range(1, n1):
        inv.append(sum((0.5 * j - m) * ms[j] * inv[m - j]
                       for j in range(1, m + 1)) / (m * ms[0]))
    out = [sum(coeffs[m - j] * inv[j] for j in range(m + 1)) * gamma
           for m in range(n1)]
    return torch.stack(out)
