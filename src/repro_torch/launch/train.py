"""End-to-end LM training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 50 --reduced --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --ntp-order 3 --device cpu

Wires together: config registry, synthetic data pipeline, the train step
(``train_loss`` under autograd, the reference's Adam with gradient
clipping), the fault-tolerant ``runtime.Trainer`` (checkpoint/restart,
straggler watchdog), and the optional n-TangentProp Sobolev regularization
(``--ntp-order``) -- the paper's technique as a first-class LM-training
feature.  A MoE arch's balance loss reaches the loss through
``train_loss`` (``Knobs.aux_coef``).  Runs on the GPU unless ``--device
cpu`` is given, on one card; the reference's sharded step is
``launch.sharding.build_train_step`` on a device mesh.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.data.tokens import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.launch.ntp_reg import ntp_smoothness
from repro_torch.models import init_model, train_loss
from repro_torch.optim import adam_init, adam_update
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.tree import leaves, unflatten

NTP_COEF = 1e-4


def train_step(cfg: ArchConfig, lr: float, ntp_order: int = 0):
    """The step ``run`` takes: ``step(params, opt, batch)`` differentiates
    ``train_loss`` (the cross-entropy plus ``Knobs.aux_coef`` x a MoE
    arch's balance loss) plus ``NTP_COEF * ntp_smoothness`` of order
    ``ntp_order`` when that is above 0, applies ``adam_update(...,
    grad_clip=1.0)`` and returns (params, opt, loss, metrics, smooth):
    metrics ``train_loss``'s ``ce`` and ``aux``, detached; smooth None
    without the penalty."""

    def step(params, opt, batch):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        p = unflatten(params, flat)
        lm_loss, metrics = train_loss(p, cfg, batch)
        smooth = ntp_smoothness(p, cfg, batch, ntp_order) if ntp_order > 0 else None
        loss = lm_loss if smooth is None else lm_loss + NTP_COEF * smooth
        grads = unflatten(params, list(torch.autograd.grad(loss, flat)))
        params, opt = adam_update(grads, opt, params, lr, grad_clip=1.0)
        return params, opt, loss.detach(), {k: v.detach() for k, v in metrics.items()}, smooth

    return step


def run(cfg: ArchConfig, shape: ShapeCfg, steps: int, lr: float = 3e-4, ntp_order: int = 0,
        ckpt_dir: str | None = None, ckpt_every: int = 20, device=None, *, seed: int = 0,
        fail_injector=None) -> dict:
    """Train ``init_model(cfg, seed)`` for ``steps`` steps of ``train_step``
    on ``synthetic_batch(cfg, shape, step)`` under the ``Trainer`` (a
    checkpoint every ``ckpt_every`` steps into ``ckpt_dir``; a run finding
    checkpoints there resumes from the latest).  Returns the final
    ``params`` and ``opt``, the Trainer's ``report``, and per step run
    (re-runs after a restart included) its ``ce``, ``aux`` (the MoE balance
    loss, 0.0 without MoE layers), ``smooth`` (0.0 without the penalty) and
    ``step_ms`` (host clock, ended by a synchronize on the card)."""
    device = resolve_device(device)
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")
    params = init_model(cfg, seed, device=device)
    opt = adam_init(params)
    step = train_step(cfg, lr, ntp_order)
    ce_hist, aux_hist, smooth_hist, step_ms = [], [], [], []

    def step_fn(state, batch):
        t0 = time.perf_counter()
        params, opt, loss, metrics, smooth = step(*state, batch)
        ce_hist.append(float(metrics["ce"]))
        aux_hist.append(float(metrics["aux"]))
        smooth_hist.append(0.0 if smooth is None else float(smooth.detach()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return (params, opt), loss

    trainer = Trainer(
        TrainerConfig(total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir),
        step_fn, lambda step: synthetic_batch(cfg, shape, step, device=device),
        straggler_cb=lambda s, dt, ema: print(f"[straggler] step {s}: {dt:.2f}s vs ema {ema:.2f}s"),
        device=device)
    (params, opt), report = trainer.run((params, opt), fail_injector=fail_injector)
    return {"params": params, "opt": opt, "report": report, "ce": ce_hist, "aux": aux_hist,
            "smooth": smooth_hist, "step_ms": step_ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ntp-order", type=int, default=0,
                    help="add an order-n jet smoothness regularizer (dense archs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeCfg("custom", args.seq, args.batch, "train")
    else:
        shape = SHAPES[args.shape]

    t0 = time.perf_counter()
    out = run(cfg, shape, args.steps, args.lr, args.ntp_order, args.ckpt_dir,
              args.ckpt_every, args.device)
    dt = time.perf_counter() - t0
    report = out["report"]
    print(f"ran {report.steps_run} steps in {dt:.1f}s "
          f"({report.restarts} restarts, {report.stragglers} stragglers)")
    print("loss first->last:", report.losses[0], "->", report.losses[-1])
    return out


if __name__ == "__main__":
    main()
