"""The traced window: ``torch.profiler`` over the measured window, reduced to
what the per-layer readers need.

The idea is ``chip_smoke.profile_ms`` (commit 52f33e3): the device's busy
time split by the port's ``<name>_kernel`` symbols, everything else being
the eager operations.  Here the raw kineto events are read (the profiler's
own event tree is not built), clipped to the window, and their intervals
merged, so busy time counts overlapping work once.  Event times are on the
host's wall clock (``time.time_ns``), the same clock the window is marked
on.  Imports nothing of the port.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from dataclasses import dataclass, field

# the port's kernel families, by the symbols of kernels/csrc/*.cu
FAMILIES = {
    "K1": re.compile(r"\bjet_dense\w*_kernel\b"),
    "K2": re.compile(r"\bact_jet\w*_kernel\b"),
    "K3": re.compile(r"\bjet_rms_norm\w*_kernel\b"),
    "K4": re.compile(r"\bjet_flash_attention\w*_kernel\b"),
    "K5": re.compile(r"\bjet_attention_scores\w*_kernel\b"),
}
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def family(name: str) -> str | None:
    for fam, pat in FAMILIES.items():
        if pat.search(name):
            return fam
    return None


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*$", "", name)          # drop the argument list
    return name[:120]


@dataclass
class Trace:
    """Device activity of one window: seconds by kernel family (and
    "eager" for the rest), kernel launches, the union of busy intervals,
    the top device operations and the idle time by what the host did."""

    window_s: float
    busy_s: float
    kernels: int
    family_s: dict
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


class Profiler:
    """``with Profiler(host_ops) as p: ...; p.mark_start(); ...;
    p.mark_end()`` then ``p.reduce()``.  ``host_ops`` also records the
    host's operations, to say what it did in the device's idle gaps; a
    window of ~10^6 launches is traced without them."""

    def __init__(self, host_ops: bool):
        self.host_ops = host_ops
        self.t0 = self.t1 = None
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        card = torch.cuda.is_available()
        acts = ([ProfilerActivity.CUDA] if card else []) + \
            ([ProfilerActivity.CPU] if self.host_ops or not card else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)

    def mark_start(self):
        self.t0 = time.time_ns()

    def mark_end(self):
        self.t1 = time.time_ns()

    def reduce(self) -> Trace:
        return reduce_events(_raw_events(self._prof), self.t0, self.t1)


def _activity(name: str, on_device: bool) -> str:
    """The kineto activity of an event, from its name where the event does
    not say (torch 2.11's events have no ``activity_type``)."""
    if on_device:
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "cuda_runtime" if name.startswith(("cuda", "cu")) else "cpu_op"


def _raw_events(prof) -> list:
    """(activity, name, start_ns, end_ns, on_device) of every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name, dev = e.name(), "CUDA" in str(e.device_type())
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else _activity(name, dev)
        out.append((kind, name, e.start_ns(), e.start_ns() + e.duration_ns(), dev))
    return out


def reduce_events(events: list, t0: int, t1: int) -> Trace:
    """Reduce raw events to a :class:`Trace` of the window [t0, t1] ns."""
    dev, host = [], []
    for kind, name, s, e, on_device in events:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if on_device and kind in _DEVICE_KINDS:
            dev.append((s, e, name, kind))
        elif not on_device and kind == "cpu_op":
            host.append((s, e, name))
    dev.sort()
    family_s: dict = defaultdict(float)
    by_op: dict = defaultdict(float)
    kernels = 0
    for s, e, name, kind in dev:
        sec = (e - s) * 1e-9
        family_s[family(name) or "eager"] += sec
        by_op[_short(name)] += sec
        kernels += kind == "kernel"
    # union of the busy intervals, and the gaps between them
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e, name, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s, _short(name)))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps += [(t0, dev[0][0], _short(dev[0][2])), (cur_e, t1, "the window's end")]
    else:
        gaps.append((t0, t1, "the window's end"))
    idle: dict = defaultdict(float)
    host.sort()
    for gs, ge, after in gaps:
        if ge > gs:
            idle[_host_at(host, gs) or f"host, then {after}"] += (ge - gs) * 1e-9
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    worst = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=(t1 - t0) * 1e-9, busy_s=busy * 1e-9, kernels=kernels,
                 family_s=dict(family_s), device_ops=[[k, v] for k, v in top],
                 idle_gaps=[[k, v] for k, v in worst])


def _host_at(host: list, t: int) -> str | None:
    """The innermost host operation running at ``t`` (host sorted by start)."""
    import bisect
    i = bisect.bisect_right(host, (t, float("inf"), ""))
    best = None
    for s, e, name in reversed(host[max(0, i - 64):i]):
        if e >= t and (best is None or s > best[0]):
            best = (s, name)
    return best[1] if best else None
