"""The plain reference agrees with the port's eager ``ntp`` engine at tiny
sizes: tables of both networks, and both training objectives."""

import math

import pytest
import torch

from ntp_bench.common import config, make_net, reference_net, seeded_params
from ntp_bench.reference import burgers, heat, tables

CPU = torch.device("cpu")
F64 = torch.float64


def _both(name, seed=3):
    from repro_torch.tree import leaves
    cfg = config(name)
    net = make_net(cfg)
    params = seeded_params(net, seed, CPU, F64)
    return cfg, net, params, reference_net(cfg, leaves(params))


def _close(got, want, tol=1e-11):
    scale = want.abs().max().clamp(min=1e-300)
    assert float((got - want).abs().max() / scale) <= tol


@pytest.mark.parametrize("order", [1, 4, 10])
def test_dense_grid(order):
    from repro_torch.core.engines import NTPEngine
    cfg, net, params, ref = _both("pinn-mlp")
    x = torch.linspace(-2, 2, 13, dtype=F64)[:, None]
    got = NTPEngine("torch").grid(net, params, x, order)
    want = tables.grid(ref, x, order)
    for k in range(order + 1):
        _close(got[:, k], want[:, k])


def test_trunk_grid_and_cross():
    from repro_torch.core.engines import NTPEngine
    cfg, net, params, ref = _both("pinn-pde-trunk")
    x = torch.rand(7, 2, generator=torch.Generator().manual_seed(1), dtype=F64) * 2 - 1
    eng = NTPEngine("torch")
    got = eng.grid(net, params, x, 4)
    want = tables.grid(ref, x, 4)
    for a in range(2):
        for k in range(5):
            _close(got[a, k], want[a, k])
    _close(eng.cross(net, params, x, (0, 0, 1, 1)), tables.cross(ref, x, (0, 0, 1, 1)), 1e-9)


def test_burgers_loss_and_gradient():
    from repro_torch.pinn.trainer import PINNRunConfig, burgers_loss_fn
    from repro_torch.tree import leaves
    cfg, net, params, _ = _both("pinn-mlp")
    g = torch.Generator().manual_seed(5)
    pts = torch.rand(32, 1, generator=g, dtype=F64) * 4 - 2
    org = torch.rand(8, 1, generator=g, dtype=F64) * 0.3 - 0.15
    lam = torch.tensor(0.3, dtype=F64)
    ls = [p.clone().requires_grad_() for p in leaves(params)] + [lam.clone().requires_grad_()]
    from repro_torch.tree import unflatten
    loss, _ = burgers_loss_fn(PINNRunConfig(k=4, engine="ntp"))(
        (unflatten(params, ls[:-1]), ls[-1]), pts, org)
    want_ls = [p.detach().clone().requires_grad_() for p in ls]
    want = burgers.loss(reference_net(cfg, want_ls[:-1]), want_ls[-1], pts, org, k=4,
                        domain=2.0)
    assert abs(float(loss) - float(want)) <= 1e-12 * abs(float(want))
    for a, b in zip(torch.autograd.grad(loss, ls), torch.autograd.grad(want, want_ls)):
        _close(a, b, 1e-10)


def test_burgers_profile_solves_its_equation():
    for x in (-2.0, 0.5, 2.0):
        u = burgers.profile(x, 4)
        assert math.isclose(-u - u ** 9, x, rel_tol=1e-14, abs_tol=1e-14)


def test_heat_loss_and_gradient():
    from repro_torch.pinn.trainer import OperatorRunConfig, operator_loss_fn
    from repro_torch.tree import leaves, unflatten
    cfg, net, params, _ = _both("pinn-pde-trunk")
    pts = torch.rand(16, 2, generator=torch.Generator().manual_seed(6), dtype=F64)
    pts[:, 1] = (pts[:, 1] * 2 - 1) * math.pi
    run_cfg = OperatorRunConfig(op="heat", network="transformer", width=32, depth=3,
                                net_kwargs={"n_heads": 2, "mlp_ratio": 2}, n_bc=8,
                                engine="ntp")
    ls = [p.clone().requires_grad_() for p in leaves(params)]
    loss, _ = operator_loss_fn(run_cfg, net, CPU)(unflatten(params, ls), pts)
    want_ls = [p.detach().clone().requires_grad_() for p in ls]
    want = heat.loss(reference_net(cfg, want_ls), pts, n_bc=8)
    assert abs(float(loss) - float(want)) <= 1e-12 * abs(float(want))
    for a, b in zip(torch.autograd.grad(loss, ls), torch.autograd.grad(want, want_ls)):
        _close(a, b, 1e-10)
