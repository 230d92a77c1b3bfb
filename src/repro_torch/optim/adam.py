"""Adam / AdamW on parameter trees, as the JAX package computes it.

State mirrors the parameter tree leaf for leaf.  The update math runs in
**float32** and casts back, as the reference's does (``optim/adam.py``):
the moments, the bias corrections and the updated parameter are float32
values even for float64 parameters, so a float64 trainer's parameters are
rounded to float32 at every Adam step.  The port keeps that on purpose so
that it computes what the reference computes (ROADMAP, Queue 3).  This is
the reference's algorithm, not ``torch.optim.Adam``.  The float32 is read
as ``torch.float32`` at call time, so a test can lift it to float64 with
the models' islands (``tests/_torch_ranks.lifted_islands``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.tree import leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any              # tree like params
    v: Any              # tree like params


def adam_init(params, state_dtype: Optional[torch.dtype] = None) -> AdamState:
    def zeros(p):
        return torch.zeros_like(p, dtype=state_dtype or p.dtype)

    device = leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adam_update(grads, state: AdamState, params, lr, *, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                grad_clip: Optional[float] = None):
    """Returns (new_params, new_state)."""
    step = state.step + 1
    if grad_clip is not None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in leaves(grads)))
        scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

    step32 = step.to(torch.float32)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=step.device) ** step32
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=step.device) ** step32

    def moments(g, m, v):
        g32 = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
        return m32, v32

    def new_param(p, g, m, v):
        m32, v32 = moments(g, m, v)
        u = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
        if weight_decay:
            u = u + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * u).to(p.dtype)

    new_p = tree_map(new_param, params, grads, state.m, state.v)
    new_m = tree_map(lambda g, m, v: moments(g, m, v)[0].to(m.dtype),
                     grads, state.m, state.v)
    new_v = tree_map(lambda g, m, v: moments(g, m, v)[1].to(v.dtype),
                     grads, state.m, state.v)
    return new_p, AdamState(step, new_m, new_v)
