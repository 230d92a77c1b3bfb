"""The dry run's counts that every torch version must reproduce.

The sharded LM steps take their layouts from DTensor's sharding
propagation wherever the model does not state them, and the propagation
differs between torch versions: where it did, one version's step gathered
a weight that another split, or reduced a partial sum twice.  So the
counts of a few cells are held fixed here, and each place that runs the
dry run holds its own torch to them: ``tests/test_torch_dryrun.py`` the
CPU's (within ``CPU_RTOL``: they cannot go stale), ``chip_smoke.py``
phase 6i the card's (within ``RTOL``).

``CELLS``: ``(arch, shape, mesh, layers)`` -> the CPU's count of that
cell (``dryrun.run_cell(..., device="cpu", layers=layers)``, torch 2.13):
``flops`` the per-rank dot FLOPs, ``collectives`` the per-rank result
bytes of each collective kind, ``gib`` the per-rank GiB (arguments and the
peak of live temporaries), printed beside another torch's and not held:
the peak follows the allocator's frees.  The cells: one for each fault in
which the sharded steps raised in DTensor at the production meshes
before their repair, at published widths with the depth cut to one layer
(zamba2: its group of 6, the shared block's; llama4's ``long_500k``: 2,
its MoE layer), llama4's ``prefill_32k`` at 2 layers, whose MoE
dispatch held whole (E, capacity) buffers on every rank, and one layer
each of the two training cells whose backward the torch versions
reduced differently before the models stated it: rwkv6's (the token-
shift mixes' gradients all-reduced one by one on torch 2.11, summed
partial on 2.13, which also reduce-scattered the decay's low-rank
gradient) and mixtral's multi-pod (the balance loss's mean, whose
gradient 2.13 reduce-scattered at (groups, tokens, experts)).

Refresh after a deliberate change of the counts:
``PYTHONPATH=src python -m repro_torch.launch.dryrun_gate`` prints the
table from the cells' CPU dry runs.  ``--compare DIR EXPECTED_DIR`` holds
a whole sweep (``dryrun --out-dir``, say on the card's torch) to another
(the CPU's) by the same rule, cell by cell.
"""

from __future__ import annotations

RTOL = 0.01
CPU_RTOL = 1e-9
# A collective kind's bytes are compared to the precision at which the dry
# run reports them (GB to 4 decimals): a kind of a few scalars -- a loss,
# a gradient norm, which one torch version all-reduces and another
# reduce-scatters -- is below it.
FLOOR_BYTES = 1e5

CELLS = {
    ('qwen3-0.6b', 'train_4k', 'single', 1): dict(
        flops=5532058124288, collectives={'all-reduce': 1099848524},
        gib=11.80),
    ('gemma3-4b', 'long_500k', 'single', 1): dict(
        flops=141950976, collectives={'all-gather': 16781312, 'all-reduce': 538624},
        gib=0.25),
    ('rwkv6-3b', 'decode_32k', 'single', 1): dict(
        flops=356679680, collectives={'all-gather': 5534720, 'all-reduce': 122880},
        gib=0.07),
    ('mixtral-8x7b', 'prefill_32k', 'multi', 1): dict(
        flops=6633593372672, collectives={'all-gather': 229900288, 'all-reduce': 2684354752},
        gib=9.14),
    ('llama4-maverick-400b-a17b', 'long_500k', 'multi', 2): dict(
        flops=179130880, collectives={'all-gather': 213277952, 'all-reduce': 2743040},
        gib=0.51),
    ('zamba2-2.7b', 'train_4k', 'single', 6): dict(
        flops=17953813954560, collectives={'all-gather': 21131661952, 'all-reduce': 8439703692},
        gib=75.42),
    ('llama4-maverick-400b-a17b', 'prefill_32k', 'multi', 2): dict(
        flops=79414074613760, collectives={'all-gather': 12503891968, 'all-reduce': 1677724672},
        gib=22.24),
    ('rwkv6-3b', 'train_4k', 'single', 1): dict(
        flops=8936048558080, collectives={'all-gather': 2013271040, 'all-reduce': 2075092108},
        gib=16.61),
    ('mixtral-8x7b', 'train_4k', 'multi', 1): dict(
        flops=9639660879872, collectives={'all-gather': 229900288, 'all-reduce': 2580742264,
                                          'reduce-scatter': 14368768},
        gib=7.33),
}


def differences(rec: dict, want: dict, rtol: float = RTOL,
                floor: float = FLOOR_BYTES) -> list:
    """What of a ``dryrun.run_cell`` record differs from ``want`` by more
    than ``rtol``: the dot FLOPs, and each collective kind's bytes (a kind
    one side lacks counts as 0 there; a difference under ``floor`` bytes
    passes)."""
    out = []
    if abs(rec["flops"] - want["flops"]) > rtol * want["flops"]:
        out.append(f"FLOPs {rec['flops']:.6e} against {want['flops']:.6e}")
    got_c, want_c = rec["collective_bytes"], want["collectives"]
    for kind in sorted(set(got_c) | set(want_c)):
        got, exp = got_c.get(kind, 0.0), want_c.get(kind, 0.0)
        if abs(got - exp) > max(rtol * exp, floor):
            out.append(f"{kind} {got:.6e} B against {exp:.6e}")
    return out


def compare(dir_a: str, dir_b: str) -> list:
    """Two sweeps' cells (``dryrun --out-dir`` JSON files, matched by name)
    held to each other by :func:`differences`, ``dir_b`` the expected:
    one row a cell, ``(name, record a, record b, its differences)``; a
    cell that raised on either side differs by its error."""
    import json
    import os
    rows = []
    for name in sorted(os.listdir(dir_b)):
        if not name.endswith(".json") or not os.path.exists(os.path.join(dir_a, name)):
            continue
        with open(os.path.join(dir_a, name)) as f:
            a = json.load(f)
        with open(os.path.join(dir_b, name)) as f:
            b = json.load(f)
        if "skipped" in a or "skipped" in b:
            continue
        if "error" in a or "error" in b:
            rows.append((name, a, b, [a.get("error") or b.get("error")]))
            continue
        rows.append((name, a, b, differences(a, {"flops": b["flops"],
                                                 "collectives": b["collective_bytes"]})))
    return rows


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", nargs=2, metavar=("DIR", "EXPECTED_DIR"),
                    help="hold one sweep's cells (dryrun --out-dir) to another's")
    args = ap.parse_args(argv)
    if args.compare:
        rows = compare(*args.compare)
        for name, a, b, diff in rows:
            gib = (f"GiB {a['per_device_mem_gb']:.2f} / {b['per_device_mem_gb']:.2f}"
                   if "per_device_mem_gb" in a and "per_device_mem_gb" in b else "")
            print(f"{'DIFF' if diff else 'same'} {name[:-5]} {gib} {'; '.join(diff)}")
        print(f"{sum(bool(d) for *_, d in rows)} of {len(rows)} cells differ")
        return 0
    from repro_torch.launch import dryrun
    print("CELLS = {")
    for (arch, shape, mesh, layers) in CELLS:
        rec = dryrun.run_cell(arch, shape, mesh, device="cpu", layers=layers, verbose=False)
        coll = {k: int(v) for k, v in sorted(rec["collective_bytes"].items())}
        print(f"    ({arch!r}, {shape!r}, {mesh!r}, {layers}): dict(\n"
              f"        flops={int(rec['flops'])}, collectives={coll},\n"
              f"        gib={rec['per_device_mem_gb']:.2f}),", flush=True)
    print("}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
