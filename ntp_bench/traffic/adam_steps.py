"""Adam steps of a PINN objective, back to back: the training cells.

Set-up builds one training state from the seed (weights on the device,
Adam's state, the objective of ``objectives/<name>.py`` through the port)
and drives it through its first ``checked_steps`` steps with
``repro_torch.pinn.trainer.adam_step`` and the window's own feed.  Those
steps warm every shape up; the window goes on from the same state.  Points
are drawn on the device from the seed and redrawn every ``resample_every``
steps, counted from the first.  ``train_step_ms`` is the window's seconds
over the steps it completed; the window ends on a synchronize.

Before the first step, set-up also takes the float64 gradient of the
port's own loss on that state and batch (``trainer.value_and_grad``, the
call ``adam_step`` makes), which the run does not use otherwise.  Once the
window has closed and the state is freed, the plain reference
(``reference/``) follows the checked steps from the same weights and
points, and four numbers are compared: the worst step's loss gap, the
worst leaf's gap of the first gradient's norm in float64 and as Adam got
it (read from its float32 first moment after one step), and the worst
leaf's gap of the parameters' change after the checked steps.  A leaf's
gap of norms is measured against the larger of the reference's norm of
that leaf and of the median leaf; the change leaves out leaves whose
reference gradient is under a thousandth of the median leaf's, which Adam
moves by rounding alone.
"""

from __future__ import annotations

import importlib
import statistics
import time

import numpy as np
import torch

from .. import cost
from ..common import (Check, Outcome, Readings, Window, make_net, memory_peak,
                      reference_net, seeded_params)
from ..reference import adam as ref_adam


def _objective(wl: dict):
    return importlib.import_module(f"ntp_bench.objectives.{wl['objective']['name']}")


def norm_gaps(got: list, want: list) -> list:
    """Per leaf: | |got| - |want| | / max(|want|, median leaf's |want|)."""
    gn = [float(torch.linalg.vector_norm(g.double())) for g in got]
    wn = [float(torch.linalg.vector_norm(w.double())) for w in want]
    med = statistics.median(wn)
    return [abs(a - b) / max(b, med) if max(b, med) > 0 else abs(a - b)
            for a, b in zip(gn, wn)]


def reference_steps(wl, cfg, init: list, batch: tuple, steps: int, dtype,
                    nudge: float = 0.0) -> dict:
    """The reference's losses, first gradient and change over ``steps``
    Adam steps from the leaves ``init`` on ``batch``, in ``dtype``.  With
    ``nudge``, every gradient element is scaled by 1 +- nudge (signs
    alternating) before Adam takes it: a probe of how far float32 rounding
    of a gradient that moved in its last digits carries into the change."""
    obj = _objective(wl)
    leaves = [p.detach().to(dtype) for p in init]
    batch = tuple(b.to(dtype) for b in batch)
    state = ref_adam.init(leaves)
    losses, first = [], None
    for _ in range(steps):
        ls = [p.clone().requires_grad_() for p in leaves]
        net_leaves, extra = obj.split_leaves(ls)
        loss = obj.reference_loss(wl, reference_net(cfg, net_leaves), extra, batch)
        grads = torch.autograd.grad(loss, ls)
        if nudge:
            sign = [1 - 2 * (torch.arange(g.numel(), device=g.device, dtype=g.dtype) % 2)
                    for g in grads]
            grads = [g * (1 + nudge * s.reshape(g.shape)) for g, s in zip(grads, sign)]
        losses.append(float(loss.detach()))
        if first is None:
            first = [g.detach() for g in grads]
        leaves, state = ref_adam.update(leaves, [g.detach() for g in grads], state,
                                        wl["objective"]["lr"])
    return {"losses": losses, "grad": first, "grad64": first,
            "change": [a.double() - b.double() for a, b in zip(leaves, init)]}


def compare(prog: dict, ref: dict) -> dict:
    """The four numbers, of a run (``prog``) against the reference."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    gnorm = [float(torch.linalg.vector_norm(g.double())) for g in ref["grad"]]
    med = statistics.median(gnorm)
    keep = [i for i, n in enumerate(gnorm) if n >= 1e-3 * med]
    return {"loss_gap": loss_gap,
            "grad64_gap": max(norm_gaps(prog["grad64"], ref["grad"])),
            "grad_gap": max(norm_gaps(prog["grad"], ref["grad"])),
            "change_gap": max(norm_gaps([prog["change"][i] for i in keep],
                                        [ref["change"][i] for i in keep])),
            "leaves": (len(keep), len(gnorm))}


class Trainer:
    """The training state the set-up builds and the window drives."""

    def __init__(self, ctx):
        from repro_torch.optim import adam_init
        from repro_torch.tree import leaves
        wl, cfg = ctx.wl, ctx.cfg
        self.ctx, self.obj = ctx, _objective(wl)
        self.spec = wl["objective"]
        net = make_net(cfg)
        params = seeded_params(net, ctx.seed, ctx.device, ctx.dtype)
        self.loss_fn, self.ps = self.obj.program(wl, cfg, net, params, ctx.device, ctx.dtype)
        self.init = [p.detach().clone() for p in leaves(self.ps)]
        self.state = adam_init(self.ps)
        self.gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1)
        self.step = 0
        self.drawn_at = None
        self.batch = None
        self.first_batch = None

    def feed(self):
        if self.step % self.spec["resample_every"] == 0 and self.drawn_at != self.step:
            self.batch = self.obj.draw(self.ctx.wl, self.gen, self.ctx.device,
                                       self.ctx.dtype)
            self.drawn_at = self.step
            if self.first_batch is None:
                self.first_batch = self.batch
        return self.batch

    def gradient(self) -> list:
        """The port's float64 gradient of its loss at the current state and
        feed, by the call ``adam_step`` makes; the state does not move."""
        from repro_torch.pinn import trainer
        from repro_torch.tree import leaves
        _, grads = trainer.value_and_grad(self.loss_fn, self.ps, *self.feed())
        return [g.detach() for g in leaves(grads)]

    def advance(self):
        from repro_torch.pinn import trainer
        batch = self.feed()
        self.ps, self.state, loss, _ = trainer.adam_step(
            self.loss_fn, self.ps, self.state, self.spec["lr"], *batch)
        self.step += 1
        return loss


def run(ctx) -> Outcome:
    from repro_torch.tree import leaves
    wl, cfg = ctx.wl, ctx.cfg
    tr = Trainer(ctx)
    checked = wl["checked_steps"]
    ctx.mark("state")
    grad64 = tr.gradient()
    losses, grad = [], None
    for i in range(checked):
        losses.append(tr.advance())
        if i == 0:      # the first gradient as Adam got it: m_1 = (1 - b1) g
            grad = [m.detach() / (1 - ref_adam.B1) for m in leaves(tr.state.m)]
    change = [p.detach().double() - q.double() for p, q in zip(leaves(tr.ps), tr.init)]
    prog = {"losses": [float(x) for x in losses], "grad": grad, "grad64": grad64,
            "change": change}
    ctx.mark("checked steps")

    stamps = []
    with Window(ctx) as w:
        stamps.append(w.t0)
        while stamps[-1] - w.t0 < ctx.seconds:
            tr.advance()
            stamps.append(time.monotonic())
        window_s = w.close()
    steps = len(stamps) - 1
    pace = [1e3 * part.mean() for part in np.array_split(np.diff(stamps), min(10, steps))]
    peak = memory_peak(ctx.device)
    first_batch, init = tr.first_batch, tr.init
    del tr
    ref = reference_steps(wl, cfg, init, first_batch, checked, ctx.dtype)
    nums = compare(prog, ref)
    checks = [Check(k, nums[k], limit) for k, limit in wl["limits"].items()]

    layers = [(layer, steps) for rows, n1 in _objective(wl).jets(wl, cfg)
              for layer in cost.jet_forward(cfg, rows, n1, _objective(wl).READOUT_ON_KERNEL)]
    readings = Readings(kind="train", window_s=window_s, units=steps, trace=w.trace,
                        layers=layers,
                        model_flops=3.0 * sum(l.flops * n for l, n in layers))

    def controls() -> dict:
        half = tuple(b[:b.shape[0] // 2] for b in first_batch)
        frozen = {"losses": [ref["losses"][0]] * checked,      # Adam's m stays 0
                  "grad": [torch.zeros_like(g) for g in ref["grad"]], "grad64": ref["grad"],
                  "change": [torch.zeros_like(c) for c in ref["change"]]}
        return {"control_float32": compare(reference_steps(wl, cfg, init, first_batch,
                                                           checked, torch.float32), ref),
                "half_batch": compare(reference_steps(wl, cfg, init, half, checked,
                                                      ctx.dtype), ref),
                "state_unchanged": compare(frozen, ref),
                "nudged_1e-9": compare(reference_steps(wl, cfg, init, first_batch, checked,
                                                       ctx.dtype, nudge=1e-9), ref)}

    notes = ["host ms a step by tenths of the window: "
             + " ".join(f"{p:.1f}" for p in pace),
             "leaves whose change is compared: %d of %d" % nums["leaves"]]
    return Outcome(attempted=steps, failed=0,
                   end_to_end={"train_step_ms": 1e3 * window_s / steps},
                   readings=readings, checks=checks, memory_peak=peak,
                   notes=notes, controls=controls)
