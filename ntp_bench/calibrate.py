"""Readings that the limits of ``correct`` are set from, on the card at the
cell's own size; the benchmark's runs do not run this.

    python3 -m ntp_bench.calibrate --workload <cell> --seeds 1,2,3 --seconds 2 \
        [--controls 3] [--out chiprun_out/calibrate.jsonl]

In one process, for each seed: one run of the cell (a short window), the
numbers compared against the plain reference, and for the first
``--controls`` seeds the same numbers of the control (the reference in
float32 put in the program's place) and, for a training cell, of the
faults (half of the batch left out; the state left unchanged) and of the
reference whose gradients are nudged by 1e-9 (float32 rounding crossings
in Adam, which sound runs can meet).  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .run import RunError, _environment, measure


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    try:
        _environment()
    except RunError as e:
        print(f"ntp_bench: {e}", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None
    try:
        for j, seed in enumerate(int(s) for s in args.seeds.split(",")):
            t = time.monotonic()
            out, ctx = measure(args.workload, seed, args.seconds, False,
                               t_start=time.monotonic())
            row = {"workload": args.workload, "seed": seed,
                   "program": {c.name: c.value for c in out.checks},
                   "end_to_end": out.end_to_end, "setup_s": ctx.setup_s}
            if j < args.controls:
                row.update(out.controls())
            row["seconds"] = time.monotonic() - t
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
