"""The heat operator by manufactured solution
(``repro_torch.pinn.trainer.operator_loss_fn`` with ``op="heat"``):
interior points uniform in [0, 1] x [-pi, pi], drawn on the device."""

from __future__ import annotations

import math

import torch

from ..reference import heat as ref


def program(wl, cfg, net, params, device, dtype):
    from repro_torch.pinn.trainer import OperatorRunConfig, operator_loss_fn
    o = wl["objective"]
    run_cfg = OperatorRunConfig(op="heat", width=cfg["width"], depth=cfg["depth"],
                                activation=cfg["activation"], network=cfg["network"],
                                net_kwargs=dict(cfg["net_kwargs"]), n_domain=o["n_domain"],
                                n_bc=o["n_bc"], adam_lr=o["lr"], engine=o["engine"])
    return operator_loss_fn(run_cfg, net, device), params


def draw(wl, gen, device, dtype):
    u = torch.rand(wl["objective"]["n_domain"], 2, generator=gen, device=device, dtype=dtype)
    lo = torch.tensor([0.0, -math.pi], dtype=dtype, device=device)
    hi = torch.tensor([1.0, math.pi], dtype=dtype, device=device)
    return (lo + (hi - lo) * u,)


# the trunk's head runs on K1
READOUT_ON_KERNEL = True


def jets(wl, cfg) -> list:
    """grid(2) on the interior points: one direction per input axis."""
    return [(cfg["d_in"] * wl["objective"]["n_domain"], 3)]


def split_leaves(leaves: list):
    return leaves, []


def reference_loss(wl, net, extra, batch):
    return ref.loss(net, batch[0], n_bc=wl["objective"]["n_bc"])
