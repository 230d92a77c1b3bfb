"""Adam as the configurations state it (the paper's code and the JAX
package alike): b1 0.9, b2 0.999, eps 1e-8, the moments, the bias
corrections and the update computed in float32, the parameter cast back to
its own dtype after each step."""

from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def init(leaves: list) -> dict:
    return {"t": 0, "m": [torch.zeros_like(p) for p in leaves],
            "v": [torch.zeros_like(p) for p in leaves]}


@torch.no_grad()
def update(leaves: list, grads: list, state: dict, lr: float):
    t = state["t"] + 1
    f32, dev = torch.float32, leaves[0].device
    step = torch.tensor(float(t), dtype=f32, device=dev)
    c1 = 1.0 - torch.tensor(B1, dtype=f32, device=dev) ** step
    c2 = 1.0 - torch.tensor(B2, dtype=f32, device=dev) ** step
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(leaves, grads, state["m"], state["v"]):
        g32 = g.to(f32)
        m32 = B1 * m.to(f32) + (1 - B1) * g32
        v32 = B2 * v.to(f32) + (1 - B2) * g32 * g32
        u = (m32 / c1) / (torch.sqrt(v32 / c2) + EPS)
        new_p.append((p.to(f32) - lr * u).to(p.dtype))
        new_m.append(m32.to(m.dtype))
        new_v.append(v32.to(v.dtype))
    return new_p, {"t": t, "m": new_m, "v": new_v}
