"""Multi-pod dry run: show that the distribution config is coherent without
the hardware.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  For
every (architecture x input shape x mesh) cell it builds the real step
(``launch.sharding.build_step``: train, prefill or serve) on the
production mesh, 256 ranks single-pod or 512 multi-pod, runs it once on
fake tensors, and reports

* whether the cell fits on a card: the per-rank bytes of the arguments
  (parameters, Adam's moments, the inputs, the decode state; from the
  bound specs, :func:`rank_bytes`) plus the peak of the step's live
  temporaries;
* the dot FLOPs and the memory traffic of the rank's local ops, and the
  collective bytes of each kind and each mesh dim (``op_static``);
* the three-term roofline with the H100's data-sheet constants
  (``op_analysis``).

Route: torch's fake process group (``FakeStore`` and the "fake" backend:
every collective returns at once and moves nothing), this process rank 0
of it; the mesh on the mesh's device type (CUDA unless ``--device cpu``);
each argument a DTensor over a local ``FakeTensor`` (shape, dtype and
device, no storage; ``FakeTensorMode``) of rank 0's shard; the step run
once under ``op_static.OpCounter``.  Two shims hold while a cell runs
(:func:`_harness`): DTensor's ``_StridedShard`` computes its shard sizes
and offsets with ``torch.arange(...).tolist()``, a data-dependent read that
fake tensors refuse, so it runs with the fake mode unset (and uncounted:
it is DTensor's bookkeeping, not the rank's work); and on a CPU mesh
DTensor replaces its all-to-all by an all-gather and a chunk (gloo has no
all-to-all), so the CPU dry run calls the all-to-all the CUDA mesh runs
(its fake kernel: nothing moves).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --device cpu --out-dir DIR

Results print to stdout, and go to one JSON file a cell under
``--out-dir``; ``--trace-dir`` keeps each cell's op log (gzipped JSON),
from which ``--reanalyze`` recomputes the JSON files without running the
steps.  A cell that raises is recorded as an error, and the command exits
1.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_arch, shape_applicable
from repro_torch.launch import op_static
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_production_mesh, production_sizes
from repro_torch.launch.op_analysis import Roofline, model_flops
from repro_torch.models.transformer import Knobs, model_dtype


def rank_bytes(tree, shardings) -> int:
    """Bytes of the largest per-rank shard of every leaf of ``tree``, laid
    out by the matching ``Sharding`` of ``shardings``."""
    pairs = []
    shd.zip_map(lambda t, s: pairs.append((t, s)), tree, shardings)
    return sum(math.prod(s.local_shape(t.shape)) * t.element_size() for t, s in pairs)


def shard_plan(archs=ASSIGNED, out=print) -> dict:
    """Every arch of ``archs`` on both production meshes (``production_
    sizes``: a mapping, no ranks) at every applicable shape, with the rules
    the builders use (FSDP where ``wants_fsdp``; sequence-parallel state at
    B = 1): per-rank bytes of the parameters (plus Adam's m and v for
    training) and of the decode state, from the bound specs on meta
    tensors.  ``out`` gets one line a cell."""
    from repro_torch.models import decode_state_specs, init_model, param_specs
    from repro_torch.models.sharding_rules import make_rules

    plan = {}
    for arch in archs:
        cfg = get_arch(arch)
        meta, specs = init_model(cfg, abstract=True), param_specs(cfg)
        n_params, fsdp = shd.arch_param_count(cfg), shd.wants_fsdp(cfg)
        for multi in (False, True):
            mesh = production_sizes(multi)
            for shape in SHAPES.values():
                if not shape_applicable(cfg, shape):
                    continue
                sp = shape.kind == "decode" and shape.global_batch == 1
                rules = make_rules(mesh, sp=sp, fsdp=fsdp)
                p_bytes = rank_bytes(meta, shd.bind_param_shardings(mesh, specs, meta, rules))
                row = {"params": n_params, "fsdp": fsdp, "param_bytes": p_bytes,
                       "adam_bytes": 2 * p_bytes if shape.kind == "train" else 0}
                if shape.kind == "decode":
                    st = decode_state_specs(cfg, shape.global_batch, shape.seq_len,
                                            abstract=True)
                    row["state_bytes"] = rank_bytes(st, shd.state_shardings(mesh, cfg, shape,
                                                                            rules))
                row["total_bytes"] = (row["param_bytes"] + row["adam_bytes"]
                                      + row.get("state_bytes", 0))
                key = f"{arch} {'x'.join(map(str, mesh.values()))} {shape.name}"
                plan[key] = row
                gib = {k: v / 2**30 for k, v in row.items() if k.endswith("_bytes")}
                extra = f" + {gib['adam_bytes']:.2f} GiB Adam" if row["adam_bytes"] else ""
                extra += (f" + {gib['state_bytes']:.2f} GiB state" if "state_bytes" in row
                          else "")
                out(f"{key}: {n_params / 1e9:.2f} B params{' (FSDP)' if fsdp else ''}, per "
                    f"rank {gib['param_bytes']:.2f} GiB params{extra} = "
                    f"{gib['total_bytes']:.2f} GiB")
    return plan


def fake_process_group(world_size: int) -> None:
    """Open (or keep) a fake default process group of ``world_size`` ranks,
    this process rank 0; a fake group of another size is replaced.  Raises
    where a real group is open."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs the fake process group; a "
                               f"{dist.get_backend()!r} group is open")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
        _forget_meshes()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _forget_meshes() -> None:
    """Clear DTensor's caches of sharding decisions and redistribution
    plans.  Their keys compare meshes by layout, so a mesh of a new group
    equal in layout to one of the group just destroyed would be handed the
    old mesh's entries, whose process groups no longer resolve (a training
    cell on the single-pod mesh after cells on the multi-pod one)."""
    from torch.distributed.tensor import DTensor, _redistribute
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if clear is not None:          # the C++ dispatch's own cache
        clear()
    prop = DTensor._op_dispatcher.sharding_propagator
    for fn in (getattr(prop, "propagate_op_sharding", None),
               getattr(prop, "_propagate_tensor_meta_cached", None),
               getattr(_redistribute, "_gen_transform_infos", None)):
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    planners = getattr(_redistribute, "_planner_cache", None)
    if isinstance(planners, dict):
        planners.clear()


@contextlib.contextmanager
def _harness(device_type: str):
    """The module notes' two shims, undone on exit."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor import _redistribute, placement_types

    undo = []

    def patch(obj, name, new):
        # the raw attribute (a class's staticmethod stays one when restored)
        undo.append((obj, name, vars(obj)[name] if isinstance(obj, type) else getattr(obj, name)))
        setattr(obj, name, new)

    strided = getattr(placement_types, "_StridedShard", None)
    raw = vars(strided).get("local_shard_size_and_offset") if strided is not None else None
    if raw is not None:
        wrapper = type(raw) if isinstance(raw, (staticmethod, classmethod)) else None
        fn = raw.__func__ if wrapper is not None else raw

        def offset(*args, **kwargs):
            with unset_fake_temporarily(), op_static.not_counted():
                return fn(*args, **kwargs)

        patch(strided, "local_shard_size_and_offset", wrapper(offset) if wrapper else offset)
    if device_type == "cpu":
        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            from torch.distributed import _functional_collectives as funcol
            group = funcol._resolve_group((mesh, mesh_dim))
            return torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim, funcol._group_or_group_name(group))

        for mod in (cu, placement_types, _redistribute):
            if hasattr(mod, "shard_dim_alltoall"):
                patch(mod, "shard_dim_alltoall", alltoall)
    try:
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)


def fake_args(built, mode, device_type: str):
    """``built``'s arguments as DTensors over rank 0's shards, each a
    FakeTensor of ``mode`` on ``device_type``."""
    from torch.distributed.tensor import DTensor

    def leaf(meta, s):
        with mode:
            t = torch.empty(s.local_shape(meta.shape), dtype=meta.dtype, device=device_type)
        stride = tuple(math.prod(meta.shape[i + 1:]) for i in range(meta.ndim))
        return DTensor.from_local(t, s.mesh, s.placements, run_check=False,
                                  shape=meta.shape, stride=stride)

    return shd.zip_map(leaf, built.arg_specs, built.arg_shardings)


def count_step(built, mesh, device: str):
    """(totals, counter) of one run of ``built.fn`` on fake arguments laid
    out by ``built.arg_shardings`` on ``mesh`` (a mesh of the fake process
    group), under the module notes' shims."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)   # the mesh's own rank tensor
    with _harness(device):
        args = fake_args(built, mode, device)
        with mode, op_static.OpCounter(mesh) as counter:
            built.fn(*args)
    return counter.totals, counter


def roofline(arch: str, shape, mesh_kind: str, cfg, totals: op_static.Totals,
             sizes: dict, mem_bytes: float) -> Roofline:
    """The :class:`Roofline` of one step's ``totals`` on a mesh of
    ``sizes`` at ``shape`` (a ``ShapeCfg``), ``mem_bytes`` a rank."""
    n_chips = math.prod(sizes.values())
    dtype = str(model_dtype(cfg)).replace("torch.", "")
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_kind, n_chips=n_chips,
        hlo_gflops=totals.flops / 1e9, hlo_gbytes=totals.bytes / 1e9,
        collective_gbytes=totals.total_collective_bytes / 1e9,
        per_device_mem_gb=mem_bytes / 2**30,
        model_gflops=model_flops(cfg, shape, n_chips) / 1e9,
        collectives={**{k: round(v / 1e9, 4) for k, v in totals.collective_bytes.items()},
                     "counts": dict(totals.collective_counts)},
        dtype=dtype, collective_dims={k: v / 1e9 for k, v in totals.collective_dims.items()},
        mesh_sizes=dict(sizes)).finalize()


def _cell_cfg(arch: str, attn_repl: bool, layers: Optional[int]):
    cfg = get_arch(arch)
    if attn_repl:
        cfg = dataclasses.replace(cfg, attn_sharding="replicate")
    if layers is not None and layers < cfg.n_layers:
        # never below one group where a block follows the group (zamba2's
        # shared attention: its weights would go unused)
        floor = cfg.group if cfg.hybrid_shared_attn_every else 1
        cfg = dataclasses.replace(cfg, n_layers=max(layers, floor))
    return cfg


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             knobs: Knobs = Knobs(), fsdp: bool | None = None, verbose: bool = True,
             policy: str = "tp", attn_repl: bool = False, accum: int | None = None,
             trace_dir: str | None = None, device: str = "cuda",
             layers: int | None = None) -> dict:
    """One cell's record (the :class:`Roofline` fields and the run's
    figures).  ``layers`` cuts the depth (the tests and the card's smoke
    phase); by default the published depth runs."""
    cfg = _cell_cfg(arch, attn_repl, layers)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": "pure full-attention arch (no long_500k cell)"}
    sizes = production_sizes(mesh_kind == "multi")
    fake_process_group(math.prod(sizes.values()))
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device_type=device)
    # a cut depth keeps the published arch's FSDP and accumulation
    full = _cell_cfg(arch, attn_repl, None)
    extra = {"fsdp": shd.wants_fsdp(full) if fsdp is None else fsdp}
    if shape.kind == "train":
        extra["accum"] = accum if accum is not None else (
            4 if shd.arch_param_count(full) >= shd.DEFAULT_ACCUM_ABOVE else 1)
        extra["policy"] = policy
    t0 = time.perf_counter()
    built = shd.build_step(cfg, mesh, shape, knobs=knobs, **extra)
    totals, counter = count_step(built, mesh, device)
    arg_bytes = rank_bytes(built.arg_specs, built.arg_shardings)
    run_s = time.perf_counter() - t0
    rl = roofline(arch, shape, mesh_kind, cfg, totals, sizes, arg_bytes + totals.peak_bytes)
    rec = rl.asdict()
    rec.update(run_s=round(run_s, 1), argument_gb=arg_bytes / 2**30,
               temp_gb=totals.peak_bytes / 2**30, ops=totals.ops, layers=cfg.n_layers,
               device=device, torch=torch.__version__, flops=totals.flops,
               collective_bytes=dict(totals.collective_bytes))
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_kind}] run {run_s:.0f}s | mem/dev "
              f"{rl.per_device_mem_gb:.2f} GiB | flops {rl.hlo_gflops:.1f}G | bytes "
              f"{rl.hlo_gbytes:.1f}G | coll {rl.collective_gbytes:.3f}G | terms c/m/x = "
              f"{rl.compute_s:.4f}/{rl.memory_s:.4f}/{rl.collective_s:.4f}s -> "
              f"{rl.bottleneck}")
        print(f"  memory: args={rec['argument_gb']:.2f} temp={rec['temp_gb']:.2f} GiB/device; "
              f"collectives GB {rl.collectives}")
        print(f"  ops {totals.ops:.0f} local; useful={rl.useful_fraction:.2f}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        with gzip.open(os.path.join(trace_dir, f"{arch}__{shape_name}__{mesh_kind}.ops.gz"),
                       "wt") as f:
            json.dump({"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                       "layers": cfg.n_layers, "attn_repl": attn_repl, "sizes": sizes,
                       "argument_bytes": arg_bytes, "peak_bytes": totals.peak_bytes,
                       "log": counter.log()}, f)
    return rec


def reanalyze(args) -> int:
    """Recompute the JSON files from the op logs under ``--trace-dir`` (an
    analysis-model change does not need the steps run again)."""
    for name in sorted(os.listdir(args.trace_dir)):
        if not name.endswith(".ops.gz"):
            continue
        with gzip.open(os.path.join(args.trace_dir, name), "rt") as f:
            trace = json.load(f)
        arch, shape_name, mesh_kind = trace["arch"], trace["shape"], trace["mesh"]
        totals = op_static.totals_from_log(trace["log"])
        cfg = _cell_cfg(arch, trace["attn_repl"], trace["layers"])
        rl = roofline(arch, SHAPES[shape_name], mesh_kind, cfg, totals, trace["sizes"],
                      trace["argument_bytes"] + trace["peak_bytes"])
        out_path = os.path.join(args.out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
        rec = {}
        if os.path.exists(out_path):
            with open(out_path) as f:
                rec = json.load(f)
        rec.update(rl.asdict())
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"reanalyzed {arch} x {shape_name} x {mesh_kind}: c={rl.compute_s:.4f}s "
              f"m={rl.memory_s:.4f}s x={rl.collective_s:.4f}s -> {rl.bottleneck}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the mesh's device type (the fake tensors' device)")
    ap.add_argument("--out-dir", default=None, help="write one JSON file a cell here")
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--kv-chunk", type=int, default=1024)
    ap.add_argument("--gla-chunk", type=int, default=64)
    ap.add_argument("--rwkv-chunk", type=int, default=32)
    ap.add_argument("--gla-pair-bf16", action="store_true")
    ap.add_argument("--policy", default="tp", choices=["tp", "dp"])
    ap.add_argument("--attn-repl", action="store_true")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every arch's depth to this many layers (zamba2: one group)")
    ap.add_argument("--tag", default="", help="suffix for result filenames (perf iterations)")
    ap.add_argument("--trace-dir", default=None,
                    help="keep each cell's op log (gzipped JSON) here")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute the JSON files of --out-dir from --trace-dir's op logs")
    args = ap.parse_args(argv)

    if args.reanalyze:
        if not (args.trace_dir and args.out_dir):
            ap.error("--reanalyze needs --trace-dir and --out-dir")
        os.makedirs(args.out_dir, exist_ok=True)
        return reanalyze(args)
    if args.device == "cuda":
        from repro_torch.device import resolve_device
        resolve_device("cuda")   # raises where there is no GPU

    knobs = Knobs(q_chunk=args.q_chunk, kv_chunk=args.kv_chunk, gla_chunk=args.gla_chunk,
                  rwkv_chunk=args.rwkv_chunk, gla_pair_bf16=args.gla_pair_bf16)
    fsdp = None if args.fsdp is None else (args.fsdp == "on")
    archs = ASSIGNED if args.all or not args.arch else (args.arch,)
    shapes = tuple(SHAPES) if args.all or not args.shape else (args.shape,)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    failures = 0
    for a in archs:
        for s in shapes:
            for m in meshes:
                try:
                    rec = run_cell(a, s, m, knobs=knobs, fsdp=fsdp, policy=args.policy,
                                   attn_repl=args.attn_repl, accum=args.accum,
                                   trace_dir=args.trace_dir, device=args.device,
                                   layers=args.layers)
                except Exception as e:  # a failure here is a fault of the port
                    traceback.print_exc()
                    print(f"[{a} x {s} x {m}] error: {e!r}")
                    rec = {"arch": a, "shape": s, "mesh": m, "error": repr(e)}
                    failures += 1
                if args.out_dir:
                    suffix = f"__{args.tag}" if args.tag else ""
                    with open(os.path.join(args.out_dir, f"{a}__{s}__{m}{suffix}.json"),
                              "w") as f:
                        json.dump(rec, f, indent=1)
    print(f"dry run: {len(archs) * len(shapes) * len(meshes)} cells, {failures} errors")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
