"""What every cell's run shares: the files it is described by, the seeded
weights, the measured window, the result line and the checks.

A run is one process.  ``run.py`` reads the cell's file
(``workloads/<cell>.json``) and its configuration (``configs/<config>.json``),
and hands them to the traffic driver the cell names
(``traffic/<driver>.py``).  The driver builds the port's objects, warms
them up, measures one :class:`Window`, and returns an :class:`Outcome`:
its end-to-end numbers, the :class:`Readings` the per-layer readers
(``metrics/<metric>.py``) take their numbers from, and the numbers that
decide ``correct``, each beside its limit.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BANNED = frozenset({"jax", "jaxlib", "flax", "repro"})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def banned_modules(modules) -> list:
    """Loaded modules whose top-level name, compared whole, is banned."""
    return sorted({m.split(".")[0] for m in modules} & BANNED)


def process_start() -> float:
    """This process's start on the ``time.monotonic`` clock (Linux: from
    /proc/self/stat in clock ticks since boot); the module's import time
    elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        if 0 <= age < 600:
            return time.monotonic() - age
    except (OSError, ValueError, IndexError):
        pass
    return _IMPORTED


_IMPORTED = time.monotonic()


@dataclass
class Check:
    """One number that decides ``correct``: it must not exceed its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Readings:
    """What the per-layer readers read.  ``units`` counts the window's Adam
    steps, ``grid`` calls or requests; ``layers`` lists (layer, count)
    pairs of the jet layers the window's work needed (``cost.Layer``);
    ``model_flops`` is the work's operations by the frozen counts;
    ``counters`` holds the program's own counters read around the window."""

    kind: str
    window_s: float
    units: int
    trace: object = None
    layers: list = field(default_factory=list)
    model_flops: float = 0.0
    counters: dict = field(default_factory=dict)


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict
    readings: Readings
    checks: list
    memory_peak: int
    notes: list = field(default_factory=list)
    # readings for setting limits (calibrate.py): the control and the faults
    # put in the program's place, compared as the run's numbers are
    controls: object = None


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    import torch
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


class Window:
    """The measured window: ``with Window(ctx) as w: ...; w.close()``.
    It starts and ends on a device synchronize; under ``--trace 1`` it runs
    inside the profiler (``trace.Profiler``), whose events it marks."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.trace = None
        self._prof = None
        self.t0 = self.t1 = None

    def __enter__(self):
        if self.ctx.trace:
            from .trace import Profiler
            self._prof = Profiler(self.ctx.wl.get("trace_host_ops", False)).__enter__()
        _sync(self.ctx.device)
        self.t0 = time.monotonic()
        self.ctx.setup_s = self.t0 - self.ctx.t_start
        self.ctx.mark("window")
        if self._prof:
            self._prof.mark_start()
        return self

    def close(self) -> float:
        _sync(self.ctx.device)
        self.t1 = time.monotonic()
        if self._prof:
            self._prof.mark_end()
        return self.seconds

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __exit__(self, *exc):
        if self._prof:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.trace = self._prof.reduce()
        return False


@dataclass
class Context:
    """One run: the cell's name and files, the seed, the window's length,
    whether it is traced, the device, and the process's start."""

    name: str
    wl: dict
    cfg: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    setup_s: float = float("nan")
    stamps: list = field(default_factory=list)

    def mark(self, label: str) -> None:
        """Note how far into set-up a phase ended (printed on stderr)."""
        self.stamps.append((label, time.monotonic() - self.t_start))

    @property
    def dtype(self):
        import torch
        return getattr(torch, self.cfg["dtype"])


def seeded_params(net, seed: int, device, dtype):
    """The network's parameter tree, drawn on the device from ``seed`` in one
    call: a matrix leaf uniform in +-sqrt(6 / (fan_in + fan_out)) (Xavier),
    a leaf the port initializes to a constant c (biases 0, gains 1) uniform
    in c +- 0.1, so that every term of every layer shows.  The tree's
    structure comes from the port's ``init`` of a template on the host."""
    import torch
    from repro_torch.tree import leaves, unflatten

    tree = net.init(torch.Generator().manual_seed(0), dtype, device="cpu")
    template = leaves(tree)
    sizes = [t.numel() for t in template]
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=g, device=device, dtype=dtype) * 2 - 1
    out = []
    for t, part in zip(template, torch.split(u, sizes)):
        part = part.reshape(t.shape)
        if t.numel() and bool((t == t.reshape(-1)[0]).all()):
            out.append(float(t.reshape(-1)[0]) + 0.1 * part)
        else:
            out.append(math.sqrt(6.0 / (t.shape[-2] + t.shape[-1])) * part)
    return unflatten(tree, out)


def make_net(cfg: dict):
    """The port's network of a configuration: the uniform (width, depth)
    vocabulary, and the network's own keywords from ``net_kwargs``."""
    from repro_torch.core.network import make_network
    return make_network(cfg["network"], d_in=cfg["d_in"], d_out=cfg["d_out"],
                        width=cfg["width"], depth=cfg["depth"],
                        activation=cfg["activation"], **cfg["net_kwargs"])


def reference_net(cfg: dict, leaves: list):
    """The plain reference of a configuration's network
    (``reference/<network>.py``) on the given leaves."""
    import importlib
    return importlib.import_module(f"ntp_bench.reference.{cfg['network']}").build(cfg, leaves)


def rel_gap(got, want) -> float:
    """max |got - want| / max |want| over a table slice (0 where both are 0)."""
    scale = float(want.abs().max())
    diff = float((got.to(want.dtype) - want).abs().max())
    if not math.isfinite(diff):
        return math.inf
    return diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)
