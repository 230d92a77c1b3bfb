"""An open loop of requests into ``repro_torch.serving.DerivativeServer``.

The schedule is fixed by the cell: ``rate_per_s`` x ``--seconds``
requests, a ``share`` of each kind of the ``mix`` in random order, rows
log-uniform in [rows_min, rows_max], Poisson gaps, all drawn from the mix's
own seed (``mix_seed``), so every run offers the same work at the same
times; ``--seed`` draws the weights and the points (uniform in [x_lo, x_hi]
per axis, on the device).  The gaps are scaled so that every request falls
due inside the window.

Each request is sent at its due time whether or not earlier ones have
finished, and is timed from its due time to its table in hand (the
server's future resolves after a device synchronize), so a stall counts
against every request it delays.  A request the server refuses or fails is
a miss: it counts in ``failed`` and at the time the run gave up on it.
``serve_p95_ms`` is the nearest-rank 95th percentile over every request of
the window.  Set-up warms each bucket of each kind once.

A sample of the requests, drawn from the seed and holding the one with the
most rows, keeps its table; once the window has closed the plain reference
recomputes each and the worst slice's gap decides ``correct``.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from .. import cost
from ..common import (Check, Outcome, Readings, Window, make_net, memory_peak,
                      reference_net, rel_gap, seeded_params)
from ..reference import tables
from .offline_tables import table_gap


def schedule(wl: dict, seconds: float) -> dict:
    """Due times (s from the window's start), rows and mix index of each
    request, from the mix's own seed."""
    n = max(1, round(wl["rate_per_s"] * seconds))
    rng = np.random.default_rng(wl["mix_seed"])
    gaps = rng.exponential(1.0, n)
    lo, hi = math.log(wl["rows_min"]), math.log(wl["rows_max"] + 1)
    rows = np.minimum(np.exp(rng.uniform(lo, hi, n)).astype(np.int64), wl["rows_max"])
    shares = np.array([m["share"] for m in wl["mix"]], dtype=np.float64)
    counts = np.floor(shares / shares.sum() * n).astype(np.int64)
    counts[0] += n - counts.sum()
    kinds = rng.permutation(np.repeat(np.arange(len(wl["mix"])), counts))
    due = seconds * (np.cumsum(gaps) - gaps[0]) / gaps.sum()
    return {"due": due, "rows": rows, "kind": kinds}


def latencies(due, done, failed, end: float):
    """Seconds from each request's due time to its table in hand; a failed
    or unfinished request counts until ``end``, when the run gave up."""
    done = np.where(failed | np.isnan(done), end, done)
    return done - due


def nearest_rank(values, q: float) -> float:
    """The smallest value with at least a share q of the values at or below
    it."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    return float(v[max(0, math.ceil(q * len(v)) - 1)])


def request_layers(cfg: dict, mix: dict, n: int) -> list:
    """The jet layers one request of n rows needs."""
    if mix["kind"] == "grid":
        return cost.jet_forward(cfg, cost.grid_rows(cfg, n), mix["order"] + 1)
    m = len(mix["axes"])
    return cost.jet_forward(cfg, cost.cross_rows(n, m), m + 1)


class _Tracker:
    """Completion times and failures, set from the server's worker."""

    def __init__(self, n: int, keep: set):
        self.done = np.full(n, np.nan)
        self.failed = np.zeros(n, dtype=bool)
        self.tables: dict = {}
        self.keep = keep
        self.left = n
        self.cv = threading.Condition()

    def finish(self, i: int, fut=None) -> None:
        t = time.monotonic()
        err = fut is None or fut.exception() is not None
        with self.cv:
            self.done[i] = t
            self.failed[i] = err
            if not err and i in self.keep:
                self.tables[i] = fut.result().table
            self.left -= 1
            self.cv.notify_all()

    def wait(self, timeout: float) -> None:
        end = time.monotonic() + timeout
        with self.cv:
            while self.left > 0 and time.monotonic() < end:
                self.cv.wait(end - time.monotonic())


def _submit(server, x, mix):
    if mix["kind"] == "grid":
        return server.submit(x, order=mix["order"])
    return server.submit(x, axes=tuple(mix["axes"]))


def run(ctx) -> Outcome:
    from repro_torch.serving.server import DerivativeServer, ServerOverloadedError
    from repro_torch.tree import leaves
    wl, cfg = ctx.wl, ctx.cfg
    sched = schedule(wl, ctx.seconds)
    n = len(sched["due"])
    net = make_net(cfg)
    params = seeded_params(net, ctx.seed, ctx.device, ctx.dtype)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1)
    total = int(sched["rows"].sum())
    pool = wl["x_lo"] + (wl["x_hi"] - wl["x_lo"]) * torch.rand(
        total, cfg["d_in"], generator=gen, device=ctx.device, dtype=ctx.dtype)
    starts = np.concatenate([[0], np.cumsum(sched["rows"])[:-1]])
    xs = [pool[s:s + r] for s, r in zip(starts.tolist(), sched["rows"].tolist())]
    pick = np.random.default_rng(ctx.seed + 2)
    keep = set(pick.choice(n, size=min(n, wl["sample"]), replace=False).tolist())
    if wl["sample"]:
        keep.add(int(np.argmax(sched["rows"])))
    tracker = _Tracker(n, keep)
    ctx.mark("inputs")
    server = DerivativeServer(net, params, wl["engine"], buckets=tuple(wl["buckets"]),
                              flush_window_s=wl["flush_window_s"],
                              max_queue=wl["max_queue"], device=ctx.device)
    try:
        for b in wl["buckets"]:
            for mix in wl["mix"]:
                _submit(server, pool[:b], mix).result()
        before = _counters(server)
        late = 0.0
        with Window(ctx) as w:
            for i in range(n):
                target = w.t0 + sched["due"][i]
                delay = target - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                late = max(late, time.monotonic() - target)
                try:
                    fut = _submit(server, xs[i], wl["mix"][sched["kind"][i]])
                except ServerOverloadedError:
                    tracker.finish(i)
                    continue
                fut.add_done_callback(lambda f, i=i: tracker.finish(i, f))
            tracker.wait(wl["drain_s"])
            window_s = w.close()
        after = _counters(server)
    finally:
        server.close()
    failed = tracker.failed | np.isnan(tracker.done)
    lat = latencies(w.t0 + sched["due"], tracker.done, failed, w.t1)
    p95 = nearest_rank(lat, 0.95)
    peak = memory_peak(ctx.device)

    net_leaves = [p.detach() for p in leaves(params)]

    def reference_tables(net, dtype) -> dict:
        out = {}
        for i in sorted(tracker.tables):
            mix, x = wl["mix"][sched["kind"][i]], xs[i].to(dtype)
            out[i] = (tables.grid(net, x, mix["order"]) if mix["kind"] == "grid"
                      else tables.cross(net, x, mix["axes"]))
        return out

    def worst(got: dict, want: dict) -> float:
        return max((table_gap(got[i], want[i]) if want[i].ndim == 4
                    else rel_gap(got[i], want[i]) for i in want), default=math.inf)

    want = reference_tables(reference_net(cfg, net_leaves), ctx.dtype)
    gap = worst(tracker.tables, want)

    def controls() -> dict:
        low = reference_net(cfg, [p.float() for p in net_leaves])
        return {"control_float32": {"table_gap": worst(
            reference_tables(low, torch.float32), want)}}

    layers = []
    for i in np.flatnonzero(~failed):
        layers += [(l, 1) for l in request_layers(cfg, wl["mix"][sched["kind"][i]],
                                                   int(sched["rows"][i]))]
    counters = {k: after[k] - before[k] for k in after}
    if wl.get("record_latencies"):
        counters["latencies_s"] = lat.tolist()
    readings = Readings(kind="serve", window_s=window_s, units=n, trace=w.trace,
                        layers=layers, model_flops=float(sum(l.flops for l, _ in layers)),
                        counters=counters)
    notes = [f"open loop: {n} requests at {wl['rate_per_s']}/s, {int(failed.sum())} "
             f"failed, sender at most {late * 1e3:.3f} ms late, p50 "
             f"{np.median(lat) * 1e3:.3f} ms, {len(want)} tables compared"]
    return Outcome(attempted=n, failed=int(failed.sum()),
                   end_to_end={"serve_p95_ms": 1e3 * p95}, readings=readings,
                   checks=[Check("table_gap", gap, wl["limits"]["table_gap"])],
                   memory_peak=peak, notes=notes, controls=controls)


def _counters(server) -> dict:
    m = server.metrics()
    return {"queue_wait_s": server.queue_wait.total, "requests": server.queue_wait.count,
            "batches": m["batches"], "pad_sum": m["pad_fraction_mean"] * m["batches"]}
