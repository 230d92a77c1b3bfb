"""The self-similar Burgers objective of profile k
(``repro_torch.pinn.trainer.burgers_loss_fn``): domain points uniform in
[-L, L] and an origin cluster uniform in [-r, r], drawn on the device."""

from __future__ import annotations

import torch

from ..reference import burgers as ref


def program(wl, cfg, net, params, device, dtype):
    from repro_torch.pinn.trainer import PINNRunConfig, burgers_loss_fn
    o = wl["objective"]
    run_cfg = PINNRunConfig(k=o["k"], width=cfg["width"], depth=cfg["depth"],
                            domain=o["domain"], n_domain=o["n_domain"],
                            n_origin=o["n_origin"], origin_radius=o["origin_radius"],
                            adam_lr=o["lr"], engine=o["engine"],
                            activation=cfg["activation"])
    lam_raw = torch.zeros((), dtype=dtype, device=device)
    return burgers_loss_fn(run_cfg), (params, lam_raw)


def draw(wl, gen, device, dtype):
    o = wl["objective"]
    u = torch.rand(o["n_domain"] + o["n_origin"], 1, generator=gen, device=device,
                   dtype=dtype) * 2 - 1
    return u[:o["n_domain"]] * o["domain"], u[o["n_domain"]:] * o["origin_radius"]


# the port's Burgers ``ntp_forward`` computes the readout outside K1
READOUT_ON_KERNEL = False


def jets(wl, cfg) -> list:
    """(rows, coefficients) of each u-jet of one loss evaluation: order 2 on
    the domain, 2k + 2 on the origin cluster, 1 at x = 0."""
    o = wl["objective"]
    return [(o["n_domain"], 3), (o["n_origin"], 2 * o["k"] + 3), (1, 2)]


def split_leaves(leaves: list):
    """The network's leaves, and lam_raw."""
    return leaves[:-1], leaves[-1:]


def reference_loss(wl, net, extra, batch):
    o = wl["objective"]
    return ref.loss(net, extra[0], *batch, k=o["k"], domain=o["domain"])
