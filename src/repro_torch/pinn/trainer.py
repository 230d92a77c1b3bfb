"""End-to-end PINN training: the self-similar Burgers profiles (``train``)
and any registered differential operator (``train_operator``).

Faithful to the paper's schedule: Adam warm phase, then L-BFGS with strong
Wolfe line search (the forward-pass-heavy phase where n-TangentProp shines).
``engine`` switches the derivative machinery between n-TangentProp (``ntp``
eager, ``ntp/cuda`` on the hand-written kernels) and the nested-autodiff
baseline with everything else identical, which is the comparison in paper
Fig. 6.  Under ``ntp/cuda`` the kernels run forward inside their
``autograd.Function``s and the backward recomputes through their plain
versions, as the reference's ``custom_vjp``s do.

Both trainers run in float64 on the CUDA device unless the caller passes
``device="cpu"``.  By default they draw the initial parameters and the
collocation points from a ``torch.Generator`` seeded with ``cfg.seed``.
They also accept injected initial parameters (``init_params``) and a
``sampler`` (Adam step -> points, called at step 0 and at every
``resample_every``-th step), so a test can replay the reference's
``jax.random`` draws and hold the two trainers step for step.

``train_operator`` trains data-parallel over ``torch.distributed``
(``OperatorRunConfig``'s ``data_parallel``, ``mesh`` and
``grad_compression``; :mod:`repro_torch.parallel`): run it on every rank
of the process group, each on its own device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.engines import DerivativeEngine
from repro_torch.core.network import Network, make_network
from repro_torch.core.ntp import MLPParams, init_mlp
from repro_torch.data.collocation import (boundary_grid, eval_grid, resample,
                                          sample_box, uniform_grid)
from repro_torch.device import resolve_device
from repro_torch.optim import adam_init, adam_update, lbfgs
from repro_torch.parallel.jet_shard import build_sharded_train_step, resolve_mesh
from repro_torch.tree import leaves, num_params, tree_map, unflatten

from .burgers import lambda_window, profile_lambda, smoothness_order
from .losses import LossWeights, bc_targets, burgers_pinn_loss, pinn_loss
from .operators import exact_values, get_operator

DTYPE = torch.float64


def value_and_grad(loss_fn: Callable, ps, *batch):
    """``((loss, aux), grads)`` of ``loss_fn(ps, *batch)``, the gradient
    taken with respect to every leaf of the tree ``ps`` (a leaf the loss
    does not reach gets zeros)."""
    ls = [leaf.detach().requires_grad_() for leaf in leaves(ps)]
    loss, aux = loss_fn(unflatten(ps, ls), *batch)
    grads = torch.autograd.grad(loss, ls, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for leaf, g in zip(ls, grads)]
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), unflatten(ps, grads)


def adam_step(loss_fn: Callable, ps, state, lr: float, *batch):
    """One Adam step on ``loss_fn(ps, *batch)``: (ps, state, loss, aux)."""
    (loss, aux), grads = value_and_grad(loss_fn, ps, *batch)
    ps, state = adam_update(grads, state, ps, lr)
    return ps, state, loss, aux


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on(device: torch.device, tree):
    return tree_map(lambda t: t.detach().to(device=device, dtype=DTYPE), tree)


# ---------------------------------------------------------------------------
# the self-similar Burgers profiles (paper section IV-C)
# ---------------------------------------------------------------------------

@dataclass
class PINNRunConfig:
    k: int = 1                      # profile index (lam = 1/2k)
    width: int = 24                 # paper's standard PINN: 3 x 24 tanh
    depth: int = 3
    domain: float = 2.0
    n_domain: int = 512
    n_origin: int = 128
    origin_radius: float = 0.15
    adam_steps: int = 1500
    adam_lr: float = 2e-3
    lbfgs_steps: int = 300
    engine: str = "ntp"             # spec: "ntp" | "ntp/cuda" | "autodiff"
    activation: str = "tanh"
    weights: LossWeights = field(default_factory=LossWeights)
    seed: int = 0
    resample_every: int = 250
    log_every: int = 250


@dataclass
class PINNResult:
    params: MLPParams
    lam: float
    lam_history: List[float]
    loss_history: List[float]
    adam_time_s: float
    lbfgs_time_s: float
    n_params: int
    order: int
    target_lam: float = float("nan")   # profile_lambda(cfg.k)
    lbfgs_evals: int = 0               # loss evaluations of the L-BFGS phase

    @property
    def lam_error(self) -> float:
        return abs(self.lam - self.target_lam)


def _lam_of(lam_raw, window):
    lo, hi = window
    return lo + (hi - lo) * torch.sigmoid(lam_raw)


def burgers_loss_fn(cfg: PINNRunConfig) -> Callable:
    """``loss_fn((params, lam_raw), pts, origin_pts) -> (loss, aux)``: the
    objective ``train`` minimizes."""
    order = smoothness_order(cfg.k)
    window = lambda_window(cfg.k)
    bc_vals = bc_targets(cfg.k, cfg.domain)

    def loss_fn(ps, pts, origin_pts):
        p, lr = ps
        return burgers_pinn_loss(p, lr, k=cfg.k, pts=pts, origin_pts=origin_pts,
                                 domain=cfg.domain, order=order,
                                 weights=cfg.weights, lam_window=window,
                                 engine=cfg.engine,
                                 activation=cfg.activation, bc_vals=bc_vals)

    return loss_fn


def train(cfg: PINNRunConfig, *, device=None, init_params: MLPParams | None = None,
          sampler: Optional[Callable[[int], tuple]] = None) -> PINNResult:
    """Adam then L-BFGS on the Burgers objective of profile ``cfg.k``.

    ``sampler(step) -> (pts, origin_pts)`` replaces the generator's draws
    at step 0 and every ``cfg.resample_every`` steps."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    params = _on(device, init_params) if init_params is not None else \
        init_mlp(gen, 1, cfg.width, cfg.depth, 1, dtype=DTYPE, device=device)
    lam_raw = torch.zeros((), dtype=DTYPE, device=device)
    order = smoothness_order(cfg.k)
    window = lambda_window(cfg.k)
    loss_fn = burgers_loss_fn(cfg)

    def draw(step):
        if sampler is not None:
            return tuple(t.to(device=device, dtype=DTYPE) for t in sampler(step))
        return resample(gen, -cfg.domain, cfg.domain, cfg.n_domain,
                        cfg.n_origin, cfg.origin_radius, DTYPE, device)

    # ---------------- Adam phase
    ps = (params, lam_raw)
    state = adam_init(ps)
    lam_hist: List[float] = []
    loss_hist: List[float] = []
    _synchronize(device)
    t0 = time.perf_counter()
    for step in range(cfg.adam_steps):
        if step == 0 or step % cfg.resample_every == 0:
            pts, origin_pts = draw(step)
        ps, state, loss, aux = adam_step(loss_fn, ps, state, cfg.adam_lr,
                                         pts, origin_pts)
        if step % cfg.log_every == 0 or step == cfg.adam_steps - 1:
            lam_hist.append(float(aux["lambda"]))
            loss_hist.append(float(loss))
    _synchronize(device)
    adam_time = time.perf_counter() - t0

    # ---------------- L-BFGS phase (fixed grid, full batch, as in the paper)
    grid = uniform_grid(-cfg.domain, cfg.domain, cfg.n_domain, DTYPE, device)
    ogrid = uniform_grid(-cfg.origin_radius, cfg.origin_radius, cfg.n_origin,
                         DTYPE, device)

    def vg_flat(p):
        (loss, _), grads = value_and_grad(loss_fn, p, grid, ogrid)
        return loss, grads

    t0 = time.perf_counter()
    # the callback samples lambda only: res.loss_history already carries the
    # full per-iteration L-BFGS losses
    res = lbfgs(vg_flat, ps, steps=cfg.lbfgs_steps,
                callback=lambda it, f, p: (
                    lam_hist.append(float(_lam_of(p[1], window)))
                    if it % 10 == 0 else None))
    _synchronize(device)
    lbfgs_time = time.perf_counter() - t0

    params, lam_raw = res.params
    return PINNResult(params=params, lam=float(_lam_of(lam_raw, window)),
                      lam_history=lam_hist,
                      loss_history=loss_hist + res.loss_history,
                      adam_time_s=adam_time, lbfgs_time_s=lbfgs_time,
                      n_params=num_params(params), order=order,
                      target_lam=profile_lambda(cfg.k), lbfgs_evals=res.n_evals)


# ---------------------------------------------------------------------------
# generic operator training (method of manufactured solutions)
# ---------------------------------------------------------------------------

@dataclass
class OperatorRunConfig:
    """Training config for any registered differential operator.

    ``engine`` accepts a spec string ("ntp", "ntp/cuda", "autodiff") or a
    :class:`DerivativeEngine` instance.  ``network`` names a registered
    architecture ("dense", "mlp", "transformer"); ``net_kwargs`` passes
    architecture extras (``{"n_heads": 2, "mlp_ratio": 2}`` for the
    transformer, whose ``width`` must be divisible by ``n_heads``).  The
    network's output rank follows the operator (``op.d_out``), so
    multi-equation systems like "gray-scott" train with no extra plumbing.

    Data parallelism (:mod:`repro_torch.parallel`): ``data_parallel=N``
    shards each collocation batch over the N ranks of the initialised
    default process group (0 = one process, the default; without such a
    group it raises); ``mesh=`` passes a :class:`DataMesh` instead.
    ``n_domain`` must be a multiple of the world size.  Every rank draws
    the same points from ``seed`` and keeps its own shard; the L-BFGS
    phase shards its objective.  ``grad_compression`` routes the Adam
    phase's gradient all-reduce through :mod:`repro_torch.parallel.
    compression`: None (exact, default), "int8", or "topk:<frac>", both
    with error feedback; it needs a mesh.
    """

    op: str = "heat"
    width: int = 32
    depth: int = 3
    activation: str = "tanh"
    network: str = "dense"
    net_kwargs: Dict = field(default_factory=dict)
    n_domain: int = 1024
    n_bc: int = 64                  # boundary points per face
    adam_steps: int = 2000
    adam_lr: float = 2e-3
    lbfgs_steps: int = 0
    engine: str = "ntp"             # spec string or DerivativeEngine
    weights: LossWeights = field(default_factory=LossWeights)
    seed: int = 0
    resample_every: int = 500
    log_every: int = 500
    eval_pts_per_axis: int = 48
    data_parallel: int = 0
    mesh: Optional[object] = None
    grad_compression: Optional[str] = None


@dataclass
class OperatorResult:
    params: object                  # the network's parameter tree
    op_name: str
    loss_history: List[float]
    l2_error: float                 # RMS vs the exact solution on a dense grid
    adam_time_s: float
    lbfgs_time_s: float
    n_params: int
    net: Optional[Network] = None


def operator_loss_fn(cfg: OperatorRunConfig, net: Network, device,
                     mesh=None) -> Callable:
    """``loss_fn(params, pts) -> (loss, aux)``: the objective
    ``train_operator`` minimizes, boundary data from the operator's exact
    solution on :func:`boundary_grid`; with ``mesh``, its grid/cross calls
    sharded over the mesh (``pinn_loss(mesh=)``)."""
    op = get_operator(cfg.op)
    engine = DerivativeEngine.from_spec(cfg.engine)
    bc_pts = boundary_grid(op.domain, cfg.n_bc, DTYPE, device)
    bc_vals = exact_values(op, bc_pts, DTYPE)

    def loss_fn(p, pts):
        return pinn_loss(p, op=op, pts=pts, bc_pts=bc_pts, bc_vals=bc_vals,
                         weights=cfg.weights, engine=engine, net=net, mesh=mesh)

    return loss_fn


def make_operator_net(cfg: OperatorRunConfig) -> Network:
    op = get_operator(cfg.op)
    return make_network(cfg.network, d_in=op.d_in, d_out=op.d_out,
                        width=cfg.width, depth=cfg.depth,
                        activation=cfg.activation, **cfg.net_kwargs)


def train_operator(cfg: OperatorRunConfig, *, device=None, init_params=None,
                   sampler: Optional[Callable[[int], torch.Tensor]] = None,
                   lbfgs_pts: torch.Tensor | None = None) -> OperatorResult:
    """Adam (+ optional L-BFGS) on the generic operator objective; the
    operator's exact solution supplies boundary/initial data and the final
    accuracy oracle.  ``sampler(step) -> pts`` replaces the generator's
    draws at step 0 and every ``cfg.resample_every`` steps; ``lbfgs_pts``
    the L-BFGS phase's fixed points.  Under a mesh, call it on every rank
    with the same arguments."""
    mesh = resolve_mesh(cfg.mesh, cfg.data_parallel)
    if mesh is None and cfg.grad_compression not in (None, "", "none"):
        raise ValueError(f"grad_compression={cfg.grad_compression!r} compresses the "
                         "data-parallel gradient all-reduce: it needs data_parallel= "
                         "or mesh=")
    if mesh is not None and cfg.n_domain % mesh.size:
        raise ValueError(f"n_domain={cfg.n_domain} does not divide the "
                         f"{mesh.size}-way data axis of the mesh")
    device = resolve_device(device)
    op = get_operator(cfg.op)
    net = make_operator_net(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    params = _on(device, init_params) if init_params is not None else \
        net.init(gen, dtype=DTYPE, device=device)
    loss_fn = operator_loss_fn(cfg, net, device)
    if mesh is not None:
        # local loss + grad on this rank's shard, the gradients summed over
        # the ranks (optionally compressed), the same Adam update everywhere
        built = build_sharded_train_step(loss_fn, mesh, adam_lr=cfg.adam_lr,
                                         compression=cfg.grad_compression)
        ef_err = built.init_err(params)

    def draw(step):
        if sampler is not None:
            return sampler(step).to(device=device, dtype=DTYPE)
        return sample_box(gen, op.domain, cfg.n_domain, DTYPE, device)

    state = adam_init(params)
    loss_hist: List[float] = []
    _synchronize(device)
    t0 = time.perf_counter()
    for step in range(cfg.adam_steps):
        if step == 0 or step % cfg.resample_every == 0:
            pts = draw(step)
        if mesh is None:
            params, state, loss, _ = adam_step(loss_fn, params, state,
                                               cfg.adam_lr, pts)
        else:
            params, state, (loss, _), ef_err = built.step(params, state, pts, ef_err)
        if step % cfg.log_every == 0 or step == cfg.adam_steps - 1:
            loss_hist.append(float(loss))
    _synchronize(device)
    adam_time = time.perf_counter() - t0

    lbfgs_time = 0.0
    if cfg.lbfgs_steps > 0:
        grid_pts = lbfgs_pts.to(device=device, dtype=DTYPE) \
            if lbfgs_pts is not None else \
            sample_box(torch.Generator().manual_seed(cfg.seed + 1), op.domain,
                       cfg.n_domain, DTYPE, device)
        # under a mesh the full-batch objective shards its grid/cross calls
        # (the whole gradient on every rank); compression is an Adam-phase
        # knob only
        lbfgs_loss = loss_fn if mesh is None else \
            operator_loss_fn(cfg, net, device, mesh)

        def vg_flat(p):
            (loss, _), grads = value_and_grad(lbfgs_loss, p, grid_pts)
            return loss, grads

        t0 = time.perf_counter()
        res = lbfgs(vg_flat, params, steps=cfg.lbfgs_steps)
        _synchronize(device)
        lbfgs_time = time.perf_counter() - t0
        params = res.params
        loss_hist.extend(res.loss_history)

    with torch.no_grad():
        xe = eval_grid(op.domain, cfg.eval_pts_per_axis, DTYPE, device)
        u_net = net.apply(params, xe)                   # (N, d_out)
        u_true = exact_values(op, xe, DTYPE)
        l2 = float(torch.sqrt(torch.mean((u_net - u_true) ** 2)))

    return OperatorResult(params=params, op_name=op.name,
                          loss_history=loss_hist, l2_error=l2,
                          adam_time_s=adam_time, lbfgs_time_s=lbfgs_time,
                          n_params=num_params(params), net=net)
