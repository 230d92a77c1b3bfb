"""The dense tanh network (``pinn-mlp``; the paper's Algorithm 1 network):
h = tanh(x W_in + b_in), then depth - 1 hidden layers, then a linear
readout.  Leaves in the order the harness hands them: W_in (d_in, w),
b_in (w,), W_hidden (depth-1, w, w), b_hidden (depth-1, w), W_out
(w, d_out), b_out (d_out,)."""

from __future__ import annotations

import torch

from . import taylor as T


class DenseNet:
    def __init__(self, cfg: dict, leaves: list):
        self.cfg = cfg
        self.w_in, self.b_in, self.w_h, self.b_h, self.w_out, self.b_out = leaves

    def jet(self, c: torch.Tensor) -> torch.Tensor:
        """(K+1, N, d_in) -> (K+1, N, d_out)."""
        h = T.tanh(T.linear(c, self.w_in, self.b_in))
        for i in range(self.w_h.shape[0]):
            h = T.tanh(T.linear(h, self.w_h[i], self.b_h[i]))
        return T.linear(h, self.w_out, self.b_out)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.jet(x[None])[0]


def build(cfg: dict, leaves: list) -> DenseNet:
    return DenseNet(cfg, leaves)
