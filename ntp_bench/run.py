"""Run one cell of the benchmark once and print its result line.

    python3 -m ntp_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its file ``ntp_bench/workloads/<cell>.json`` names the
configuration, the traffic driver (``ntp_bench/traffic/<driver>.py``), the
traffic's parameters and the limits of the numbers that decide
``correct``.  With ``--trace 0`` the line carries the cell's end-to-end
metrics; with ``--trace 1`` the window runs under the profiler and the line
carries the per-layer metrics, each read by ``ntp_bench/metrics/<name>.py``.

The port (``src/repro_torch``) is the system under test.  The run fails,
printing no result, where there is no CUDA device, fewer than the cell asks
for, no port beside the benchmark, or where ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro`` was loaded.
"""

from __future__ import annotations

from .common import process_start

T_START = process_start()

import argparse                      # noqa: E402  -- the clock starts first
import importlib.util                # noqa: E402
import json                          # noqa: E402
import os                            # noqa: E402
import sys                           # noqa: E402

from .common import (BENCH, ROOT, Context, banned_modules, config,  # noqa: E402
                     load_json, workload)


class RunError(RuntimeError):
    """The run cannot measure: it prints no result and exits non-zero."""


def _cells_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics of ``BENCHMARK.json`` this cell reports in this mode."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"ntp_bench.metrics.{name.replace('.', '_')}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _environment() -> None:
    """Build and kernel caches inside the checkout, at fixed paths (the port
    builds its kernels into ``src/repro_torch/kernels/_build``), and the
    port on the path."""
    cache = ROOT / ".ntp_bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise RunError(f"the port is not beside the benchmark ({src / 'repro_torch'} missing)")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))


def measure(name: str, seed: int, seconds: float, trace: bool, device=None,
            t_start: float | None = None):
    """Run the cell once; (outcome, context).  ``device`` defaults to the
    CUDA device; the tests pass the CPU and shrunken cells."""
    wl = workload(name) if isinstance(name, str) else name
    cfg = config(wl["config"])
    import torch
    if device is None:
        need = int(wl.get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise RunError(f"the cell needs {need} CUDA device(s); {have} available")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    if trace:       # a window of ~10^6 launches is traced for a part of its length
        seconds = min(seconds, wl.get("trace_seconds", seconds))
    ctx = Context(name=wl["name"], wl=wl, cfg=cfg, seed=seed, seconds=seconds,
                  trace=trace, device=device,
                  t_start=T_START if t_start is None else t_start)
    driver = importlib.import_module(f"ntp_bench.traffic.{wl['driver']}")
    ctx.mark("imports")
    return driver.run(ctx), ctx


def result_line(bench: dict, ctx, out, trace: bool) -> dict:
    import torch
    metrics = {}
    for m in _cells_metrics(bench, ctx.name, trace):
        if trace:
            value = _reader(m["name"]).read(out.readings)
        elif m["name"] == "setup_s":
            value = ctx.setup_s
        else:
            value = out.end_to_end.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = ctx.device.type == "cuda"
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
              "count": int(ctx.wl.get("chips", 1)),
              "memory_peak_bytes": out.memory_peak}
    line = {"correct": all(c.ok for c in out.checks), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    tr = out.readings.trace
    if trace and tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = load_json(ROOT / "BENCHMARK.json")
        if args.workload not in {w["name"] for w in bench["workloads"]}:
            raise RunError(f"no cell {args.workload!r} in BENCHMARK.json")
        _environment()
        out, ctx = measure(args.workload, args.seed, args.seconds, bool(args.trace))
        banned = banned_modules(sys.modules)
        if banned:
            raise RunError(f"modules loaded that the port must not load: {banned}")
        line = result_line(bench, ctx, out, bool(args.trace))
    except RunError as e:
        print(f"ntp_bench: {e}", file=sys.stderr)
        return 2
    for note in out.notes:
        print(note, file=sys.stderr)
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in ctx.stamps), file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
