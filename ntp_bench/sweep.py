"""Find the serving cell's knee: the open loop at a list of fixed rates, one
short window each, in one process; the benchmark's runs do not run this.

    python3 -m ntp_bench.sweep --workload trunk-serve --rates 50,100,200 \
        --seconds 10 --seed 7

For each rate one JSON line: requests, failures, completions a second,
p50 / p95 / max latency from the due time, and the median latency of the
window's last quarter of requests over its first (a backlog that grows
reads well above 1).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np

from .common import workload
from .run import RunError, _environment, measure


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    try:
        _environment()
    except RunError as e:
        print(f"ntp_bench: {e}", file=sys.stderr)
        return 2
    for rate in (float(r) for r in args.rates.split(",")):
        wl = copy.deepcopy(workload(args.workload))
        wl.update(rate_per_s=rate, sample=0, record_latencies=True)
        t = time.monotonic()
        out, _ = measure(wl, args.seed, args.seconds, False, t_start=time.monotonic())
        lat = np.asarray(out.readings.counters["latencies_s"]) * 1e3
        q = max(1, len(lat) // 4)
        print(json.dumps({
            "rate_per_s": rate, "requests": out.attempted, "failed": out.failed,
            "completed_per_s": (out.attempted - out.failed) / out.readings.window_s,
            "p50_ms": float(np.median(lat)), "p95_ms": out.end_to_end["serve_p95_ms"],
            "max_ms": float(lat.max()),
            "growth": float(np.median(lat[-q:]) / np.median(lat[:q])),
            "queue_wait_ms": 1e3 * out.readings.counters["queue_wait_s"]
            / max(1, out.readings.counters["requests"]),
            "seconds": time.monotonic() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
