"""Offline derivative tables: ``DerivativeEngine.grid`` calls issued back to
back under ``torch.no_grad()``, with no synchronize between them.

Set-up draws the weights and a pool of inputs on the device from the seed
(``pool`` batches of ``rows`` points uniform in [x_lo, x_hi] per axis) and
warms the call up.  The window cycles through the pool until ``--seconds``
have passed on the host's clock, then synchronizes: ``table_rows_per_s``
is the rows of every call issued, all complete at that synchronize, over
the window's seconds.  A sample of the calls, drawn from the seed as they
are issued (reservoir sampling) and always holding the last, keeps its
table; once the window has closed the plain reference recomputes each and
the worst slice's gap (one input axis, one order) decides ``correct``.
"""

from __future__ import annotations

import random
import time

import torch

from .. import cost
from ..common import (Check, Outcome, Readings, Window, make_net, memory_peak,
                      reference_net, rel_gap, seeded_params)
from ..reference import tables


def table_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst (axis, order) slice of a grid table."""
    return max(rel_gap(got[a, k], want[a, k])
               for a in range(want.shape[0]) for k in range(want.shape[1]))


def run(ctx) -> Outcome:
    from repro_torch.core.engines import DerivativeEngine
    from repro_torch.tree import leaves
    wl, cfg = ctx.wl, ctx.cfg
    rows, order, pool = wl["rows"], wl["order"], wl["pool"]
    net = make_net(cfg)
    params = seeded_params(net, ctx.seed, ctx.device, ctx.dtype)
    engine = DerivativeEngine.from_spec(wl["engine"])
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1)
    xs = (wl["x_lo"] + (wl["x_hi"] - wl["x_lo"]) * torch.rand(
        pool * rows, cfg["d_in"], generator=gen, device=ctx.device, dtype=ctx.dtype)
          ).split(rows)
    pick = random.Random(ctx.seed)
    ctx.mark("inputs")
    kept: list = []
    with torch.no_grad():
        for i in range(wl["warmup_calls"]):
            engine.grid(net, params, xs[i % pool], order)
        with Window(ctx) as w:
            calls = 0
            while True:
                out = engine.grid(net, params, xs[calls % pool], order)
                calls += 1
                if len(kept) < wl["sample"]:
                    kept.append((calls - 1, out))
                else:
                    j = pick.randrange(calls)
                    if j < wl["sample"]:
                        kept[j] = (calls - 1, out)
                if time.monotonic() - w.t0 >= ctx.seconds:
                    break
            window_s = w.close()
    if all(i != calls - 1 for i, _ in kept):
        kept[-1] = (calls - 1, out)
    peak = memory_peak(ctx.device)
    net_leaves = [p.detach() for p in leaves(params)]
    ref = reference_net(cfg, net_leaves)
    want = {i: tables.grid(ref, xs[i % pool], order) for i, _ in kept}
    gap = max(table_gap(t, want[i]) for i, t in kept)

    def controls() -> dict:
        low = reference_net(cfg, [p.float() for p in net_leaves])
        return {"control_float32": {"table_gap": max(
            table_gap(tables.grid(low, xs[i % pool].float(), order), want[i])
            for i, _ in kept)}}
    layers = [(layer, calls) for layer in
              cost.jet_forward(cfg, cost.grid_rows(cfg, rows), order + 1)]
    readings = Readings(kind="table", window_s=window_s, units=calls, trace=w.trace,
                        layers=layers, model_flops=float(sum(l.flops * n for l, n in layers)))
    return Outcome(attempted=calls, failed=0,
                   end_to_end={"table_rows_per_s": calls * rows / window_s},
                   readings=readings,
                   checks=[Check("table_gap", gap, wl["limits"]["table_gap"])],
                   memory_peak=peak, controls=controls)
