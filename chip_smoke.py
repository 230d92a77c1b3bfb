#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each failing loudly with a non-zero exit:

1. the card's name and power limit (``nvidia-smi``), then the build of the
   hand-written kernels from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a);
2. every kernel against its plain PyTorch version on the card: K2
   (``act_jet``) for tanh/sigmoid/sin, orders 1-8, f32 and f64, ragged and
   serving shapes (tolerances at TOL_F64 / TOL_F32 below); K1 (``jet_dense``) for None/tanh/sigmoid/sin at the served
   model's layer shapes (2->32, 32->32, 32->1) and a ragged one;
3. the served main path: a ``DerivativeServer`` on the ``pinn-pde`` DenseMLP
   (d_in 2, width 32, depth 3, d_out 1, tanh, float64, random weights from
   ``--seed``) under engine ``ntp/cuda``, plus the same weights as a module
   graph with standalone Activation leaves (the K2 launch), both answering
   concurrent ``grid(order=4)``, ``cross((0,0,1,1))`` and ``cross((0,1))``
   requests of 5..512 rows.  Every table is held against the eager ``ntp``
   engine on the card and against nested autodiff; the launch counters,
   zeroed just before this phase and read just after, must show 4 K1
   launches per engine call (and 3 K2 launches per call of the unfused
   graph);
4. times from CUDA events after warm-up at the 512-row serving shapes: each
   kernel's device time (the host's enqueue kept off the clock, see
   ``device_time_ms``) and host dispatch time, its plain version, the GEMM
   part alone (``torch.matmul``), the bound from bytes and operations, and
   per request kind the server's p50/p99 for ``ntp/cuda`` and eager ``ntp``
   beside the engine call's device time;
5. a JSON line describing each kernel, the ``nvidia-smi`` line, and as the
   last line ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``.  The
script imports nothing of JAX: it needs PyTorch with CUDA and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet): HBM 3.35 TB/s,
# float32 outside the tensor cores 67 TFLOP/s; float64 is bounded by the
# same 67 TFLOP/s (the FP64 tensor-core rate, the card's f64 peak).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"torch.float32": 67e12, "torch.float64": 67e12}

DEVICE = "cuda"

# Kernel vs plain version on the same inputs, relative to each order's
# max |plain|.  f64: 1e-12 at every order.  f32: 1e-5 (what
# tests/test_parity.py uses between ntp and ntp/pallas) through order 4;
# above it the jet's own float32 conditioning dominates (two f32 versions
# that round in another order drift apart by ~1e-5 at order 7), so there
# the kernel must stay within F32_DRIFT times the plain version's own
# float32 error against the float64 plain result on the same inputs.
TOL_F64 = 1e-12
TOL_F32 = 1e-5
F32_EXACT_ORDERS = 4
F32_DRIFT = 4.0
TOL_SERVED = 1e-12     # served ntp/cuda vs eager ntp, relative per table slice
TOL_AUTODIFF = 1e-9    # vs nested autodiff: that tower's own rounding


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_err(a, b, keep: int) -> float:
    """max |a - b| / max |b| over each slice of the leading ``keep`` axes,
    worst slice."""
    import torch
    a, b = a.double(), b.double()
    lead = tuple(b.shape[:keep])
    d = (a - b).abs().reshape(lead + (-1,)).amax(-1)
    s = b.abs().reshape(lead + (-1,)).amax(-1).clamp_min(1e-300)
    return float((d / s).max()) if d.numel() else 0.0


def device_time_ms(fn, reps: int, warmup: int = 3) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn``.

    A spin kernel (``torch.cuda._sleep``) holds the device while the host
    enqueues ``reps`` calls, so the CUDA events around them bracket
    back-to-back device work with no host gaps: the device time excludes
    Python dispatch, which the host time (enqueue cost per call) reports.
    Keep ``reps`` x kernels-per-call well under the launch queue's depth."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        ts, t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        ts.record()
        torch.cuda._sleep(cycles)
        t0.record()
        h0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - h0) * 1e3
        t1.record()
        torch.cuda.synchronize()
        spin_ms = ts.elapsed_time(t0)
        if spin_ms > 1.2 * host_ms:          # the queue filled before the spin ended
            return t0.elapsed_time(t1) / reps, host_ms / reps
        cycles = int(cycles * 2 * host_ms / max(spin_ms, 1e-3))
    raise SmokeFailure("the spin kernel never outlasted the host's enqueue")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stdout.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def holds(got, want, plain, args, dt, n: int, what: str) -> float:
    """Check a kernel's output against its plain version (see TOL_*)."""
    import torch
    e = rel_err(got, want, 1)
    if dt == torch.float64:
        require(e <= TOL_F64, f"{what}: rel err {e:.3e} > {TOL_F64:.0e}")
    elif n <= F32_EXACT_ORDERS:
        require(e <= TOL_F32, f"{what}: rel err {e:.3e} > {TOL_F32:.0e}")
    elif e > TOL_F32:
        exact = plain(*(a.double() for a in args))
        e_kernel, e_plain = rel_err(got, exact, 1), rel_err(want, exact, 1)
        require(e_kernel <= F32_DRIFT * max(e_plain, TOL_F32),
                f"{what}: f32 error vs f64 {e_kernel:.3e}, the plain version's "
                f"{e_plain:.3e}; allowed {F32_DRIFT:g}x")
    return e


def check_kernels(gen, report: dict) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.jet_dense import jet_dense_cuda
    from repro_torch.kernels.tanh_jet import act_jet_cuda

    worst = {"act_jet": 0.0, "jet_dense": 0.0}
    rows = []
    for dt in (torch.float32, torch.float64):
        tol = TOL_F32 if dt == torch.float32 else TOL_F64
        for act in ("tanh", "sigmoid", "sin"):
            for shape in ((37, 45), (8192, 32)):
                e_max = 0.0
                for n in range(1, 9):
                    x = 0.5 * torch.randn((n + 1,) + shape, generator=gen,
                                          device=DEVICE, dtype=dt)
                    got, want = act_jet_cuda(x, act), ref.act_jet_ref(x, act)
                    torch.cuda.synchronize()
                    e = holds(got, want, lambda c: ref.act_jet_ref(c, act), (x,),
                              dt, n, f"act_jet {act} {dt} order {n} {shape}")
                    e_max = max(e_max, e)
                    worst["act_jet"] = max(worst["act_jet"],
                                           float((got - want).abs().max()))
                rows.append(("act_jet", str(dt), act, shape, "1-8", e_max, tol))
        for act in (None, "tanh", "sigmoid", "sin"):
            for bsz, din, dout in ((8192, 2, 32), (8192, 32, 32), (8192, 32, 1),
                                   (77, 13, 45)):
                e_max = 0.0
                for n in (1, 4, 8):
                    x = 0.5 * torch.randn((n + 1, bsz, din), generator=gen,
                                          device=DEVICE, dtype=dt)
                    w = torch.randn((din, dout), generator=gen, device=DEVICE,
                                    dtype=dt) / din ** 0.5
                    b = 0.1 * torch.randn((dout,), generator=gen, device=DEVICE,
                                          dtype=dt)
                    got = jet_dense_cuda(x, w, b, act)
                    want = ref.jet_dense_ref(x, w, b, act)
                    torch.cuda.synchronize()
                    e = holds(got, want,
                              lambda c, ww, bb: ref.jet_dense_ref(c, ww, bb, act),
                              (x, w, b), dt, n, f"jet_dense {act} {dt} order {n} "
                                                f"({bsz},{din}->{dout})")
                    e_max = max(e_max, e)
                    worst["jet_dense"] = max(worst["jet_dense"],
                                             float((got - want).abs().max()))
                rows.append(("jet_dense", str(dt), str(act), (bsz, din, dout),
                             "1,4,8", e_max, tol))
    for r in rows:
        print(f"  {r[0]:9s} {r[1]:13s} {r[2]:7s} {str(r[3]):15s} orders {r[4]:5s} "
              f"max rel err {r[5]:.2e} (tol {r[6]:.0e})")
    report["kernel_checks"] = [dict(zip(("kernel", "dtype", "activation", "shape",
                                         "orders", "max_rel_err", "tol"), r))
                               for r in rows]
    return worst


# ---------------------------------------------------------------------------
# phase 3: the served main path
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModuleNet:
    """A network given as a bare module graph (the DenseMLP's layers with
    their activations as standalone Activation leaves)."""

    graph: object
    d_in: int
    d_out: int
    activation: str = "tanh"

    def apply(self, params, x):
        return self.graph.apply(params, x)

    def jet_apply(self, params, jet, *, impl="torch"):
        return self.graph.jet_apply(params, jet, impl=impl)


def unfused(net, params):
    from repro_torch.core.modules import Activation, Dense, Sequential
    mods, ps = [], []
    layers = [(params.w_in, params.b_in)] + [
        (params.w_hidden[i], params.b_hidden[i])
        for i in range(params.w_hidden.shape[0])]
    for w, b in layers:
        mods += [Dense(w.shape[0], w.shape[1], None), Activation(net.activation)]
        ps += [(w, b), ()]
    mods.append(Dense(net.width, net.d_out, None))
    ps.append((params.w_out, params.b_out))
    return ModuleNet(Sequential(tuple(mods)), net.d_in, net.d_out), tuple(ps)


REQUESTS = (("grid", 4), ("cross", (0, 0, 1, 1)), ("cross", (0, 1)))
SIZES = (5, 37, 200, 512)


def serve_main_path(net, params, gen, report: dict) -> dict:
    import torch
    from repro_torch.core.engines import DerivativeEngine
    from repro_torch.kernels import ops
    from repro_torch.serving import DerivativeServer

    mnet, mparams = unfused(net, params)
    eager, autodiff = (DerivativeEngine.from_spec(s) for s in ("ntp", "autodiff"))
    xs = {n: torch.rand((n, net.d_in), generator=gen, device=DEVICE,
                        dtype=torch.float64) * 2 - 1 for n in SIZES}
    jobs = [(kind, req, n) for kind, req in REQUESTS for n in SIZES]

    servers = {"ntp/cuda": DerivativeServer(net, params, "ntp/cuda"),
               "ntp/cuda unfused": DerivativeServer(mnet, mparams, "ntp/cuda")}
    results, errors = {}, []

    def client(name, server, part):
        try:
            futs = [(job, server.submit(xs[job[2]], **(
                {"order": job[1]} if job[0] == "grid" else {"axes": job[1]})))
                for job in part]
            for job, f in futs:
                results[(name,) + job] = f.result(timeout=600).table
        except Exception as exc:                      # noqa: BLE001
            errors.append(f"{name} {exc!r}")          # re-raised below

    ops.reset_launch_counts()
    try:
        threads = [threading.Thread(target=client, args=(name, srv, jobs[i::3]))
                   for name, srv in servers.items() for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        metrics = {name: srv.metrics() for name, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.close()
    require(not any(t.is_alive() for t in threads), "a client thread hung")
    require(not errors, f"served requests failed: {errors}")
    require(len(results) == 2 * len(jobs), "missing served results")

    batches = {name: m["batches"] for name, m in metrics.items()}
    want_k1 = 4 * batches["ntp/cuda"] + 4 * batches["ntp/cuda unfused"]
    want_k2 = 3 * batches["ntp/cuda unfused"]
    print(f"  launches in the served run: {launches}; engine calls (batches): "
          f"{batches}; expected jet_dense {want_k1}, act_jet {want_k2}")
    require(launches["jet_dense"] == want_k1,
            f"jet_dense launched {launches['jet_dense']} times, want {want_k1}")
    require(launches["act_jet"] == want_k2,
            f"act_jet launched {launches['act_jet']} times, want {want_k2}")

    worst = {"served_vs_eager": 0.0, "served_vs_autodiff": 0.0,
             "unfused_vs_eager": 0.0}
    with torch.no_grad():
        for kind, req, n in jobs:
            x = xs[n]
            if kind == "grid":
                direct = eager.grid(net, params, x, req)
                keep = 2
            else:
                direct = eager.cross(net, params, x, req)
                keep = 0
            served = results[("ntp/cuda", kind, req, n)]
            other = results[("ntp/cuda unfused", kind, req, n)]
            require(served.shape == direct.shape and bool(torch.isfinite(served).all()),
                    f"served {kind} {req} N={n}: shape {tuple(served.shape)} "
                    f"want {tuple(direct.shape)}, or non-finite values")
            e = rel_err(served, direct, keep)
            e2 = rel_err(other, direct, keep)
            worst["served_vs_eager"] = max(worst["served_vs_eager"], e)
            worst["unfused_vs_eager"] = max(worst["unfused_vs_eager"], e2)
            require(e <= TOL_SERVED, f"served {kind} {req} N={n} vs eager: {e:.3e}")
            require(e2 <= TOL_SERVED, f"unfused {kind} {req} N={n} vs eager: {e2:.3e}")
    for kind, req, n in jobs:
        x = xs[n]
        ad = (autodiff.grid(net, params, x, req) if kind == "grid"
              else autodiff.cross(net, params, x, req))
        e = rel_err(results[("ntp/cuda", kind, req, n)], ad.detach(),
                    2 if kind == "grid" else 0)
        worst["served_vs_autodiff"] = max(worst["served_vs_autodiff"], e)
        require(e <= TOL_AUTODIFF, f"served {kind} {req} N={n} vs autodiff: {e:.3e}")
    print(f"  served tables: {len(jobs)} per server; worst rel err vs eager ntp "
          f"{worst['served_vs_eager']:.2e} (tol {TOL_SERVED:.0e}), unfused vs "
          f"eager {worst['unfused_vs_eager']:.2e}, vs autodiff "
          f"{worst['served_vs_autodiff']:.2e} (tol {TOL_AUTODIFF:.0e})")
    report["served"] = {"launches": launches, "batches": batches,
                        "worst_rel_err": worst, "metrics": metrics}
    return launches


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def bound_ms(nbytes: int, flops: int, dtype: str) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def time_kernels(net, params, gen, report: dict) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.bell_tables import flop_estimate
    from repro_torch.kernels.jet_dense import jet_dense_cuda
    from repro_torch.kernels.tanh_jet import act_jet_cuda

    n1, width = 5, net.width                 # order 4, the served requests
    out = {}
    for label, rows in (("grid512", 2 * 512), ("cross512", 16 * 512)):
        x = 0.5 * torch.randn((n1, rows, width), generator=gen, device=DEVICE,
                              dtype=torch.float64)
        w, b = params.w_hidden[0], params.b_hidden[0]
        item = x.element_size()
        k1, k1_host = device_time_ms(lambda: jet_dense_cuda(x, w, b, "tanh"), 100)
        k1_plain, _ = device_time_ms(lambda: ref.jet_dense_ref(x, w, b, "tanh"), 3)
        xf = x.reshape(n1 * rows, width)
        gemm, _ = device_time_ms(lambda: torch.matmul(xf, w), 100)
        k2, k2_host = device_time_ms(lambda: act_jet_cuda(x, "tanh"), 100)
        k2_plain, _ = device_time_ms(lambda: ref.act_jet_ref(x, "tanh"), 3)
        k1_bytes = (x.numel() + w.numel() + b.numel() + n1 * rows * width) * item
        k1_flops = 2 * n1 * rows * width * width + rows * width \
            + flop_estimate(n1 - 1, rows, width)
        k2_bytes = 2 * x.numel() * item
        k2_flops = flop_estimate(n1 - 1, rows, width)
        k1_bound = bound_ms(k1_bytes, k1_flops, str(x.dtype))
        k2_bound = bound_ms(k2_bytes, k2_flops, str(x.dtype))
        err1 = float((jet_dense_cuda(x, w, b, "tanh")
                      - ref.jet_dense_ref(x, w, b, "tanh")).abs().max())
        err2 = float((act_jet_cuda(x, "tanh") - ref.act_jet_ref(x, "tanh")).abs().max())
        out[label] = {
            "shape": [n1, rows, width], "dtype": str(x.dtype),
            "jet_dense": {"ms": k1, "host_ms": k1_host, "plain_ms": k1_plain,
                          "gemm_only_ms": gemm,
                          "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
                          "bytes": k1_bytes, "flops": k1_flops, "max_abs_err": err1},
            "act_jet": {"ms": k2, "host_ms": k2_host, "plain_ms": k2_plain,
                        "bound_ms": k2_bound[0],
                        "bound_by": k2_bound[1], "bytes": k2_bytes,
                        "flops": k2_flops, "max_abs_err": err2},
        }
        print(f"  {label} hidden layer (5, {rows}, 32)x(32, 32) f64 tanh: "
              f"jet_dense {k1 * 1e3:.2f} us (plain {k1_plain * 1e3:.2f} us, "
              f"GEMM part alone {gemm * 1e3:.2f} us, bound {k1_bound[0] * 1e3:.2f} us "
              f"by {k1_bound[1]}; host dispatch {k1_host * 1e3:.2f} us); act_jet "
              f"{k2 * 1e3:.2f} us (plain {k2_plain * 1e3:.2f} us, bound "
              f"{k2_bound[0] * 1e3:.2f} us by {k2_bound[1]}; host dispatch "
              f"{k2_host * 1e3:.2f} us)")
    report["kernel_times"] = out
    return out


def time_server(net, params, gen, report: dict) -> dict:
    """Per request kind at the 512 bucket: the server's latency (one client,
    no flush window) beside the device time of the bare engine call, whose
    ratio is the device's busy share of a request."""
    import torch
    from repro_torch.core.engines import DerivativeEngine
    from repro_torch.serving import DerivativeServer

    x = torch.rand((512, net.d_in), generator=gen, device=DEVICE,
                   dtype=torch.float64) * 2 - 1
    out = {}
    for spec in ("ntp/cuda", "ntp"):
        engine = DerivativeEngine.from_spec(spec)
        for kind, req in REQUESTS[:2]:
            fn = engine.grid if kind == "grid" else engine.cross
            with torch.no_grad():
                dev_ms, host_ms = device_time_ms(lambda: fn(net, params, x, req),
                                                 3 if spec == "ntp/cuda" else 1)
            with DerivativeServer(net, params, spec, flush_window_s=0.0) as srv:
                call = (lambda: srv.grid(x, req)) if kind == "grid" else \
                    (lambda: srv.cross(x, req))
                for _ in range(10):
                    call()
                srv.latency = type(srv.latency)()
                t0 = time.perf_counter()
                for _ in range(100):
                    call()
                wall = time.perf_counter() - t0
                lat = srv.latency.snapshot()
            key = f"{spec} {kind}{req} N=512"
            busy = dev_ms * 1e3 / lat["p50_us"]
            out[key] = {"p50_us": lat["p50_us"], "p99_us": lat["p99_us"],
                        "mean_us": lat["mean_us"], "requests_per_s": 100 / wall,
                        "engine_device_us": dev_ms * 1e3,
                        "engine_host_us": host_ms * 1e3, "device_busy_share": busy}
            print(f"  server {key}: p50 {lat['p50_us']:.1f} us, p99 "
                  f"{lat['p99_us']:.1f} us, {100 / wall:.1f} requests/s (one client); "
                  f"engine call: device {dev_ms * 1e3:.1f} us, host enqueue "
                  f"{host_ms * 1e3:.1f} us; device busy {100 * busy:.1f}% of p50")
    report["server_latency"] = out
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, inputs and queries")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch next to {__file__}; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.network import DenseMLP
    from repro_torch.kernels import cuda_lib

    report: dict = {"seed": args.seed}
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    cuda_lib.library()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", cuda_lib.LIBRARY.build_log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                         cuda_lib.LIBRARY.build_log)]
    print(f"    kernels built in {cuda_lib.LIBRARY.build_seconds:.1f} s; "
          f"{len(regs)} instantiations, registers max {max(regs, default=0)}, "
          f"spill stores max {max(spills, default=0)} bytes")
    report.update(device=kind, nvidia_smi=smi, build_seconds=cuda_lib.LIBRARY.build_seconds,
                  max_registers=max(regs, default=0), max_spill_bytes=max(spills, default=0))

    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
    print("[2] kernels against their plain versions")
    worst = check_kernels(gen, report)

    net = DenseMLP(d_in=2, width=32, depth=3, d_out=1, activation="tanh")
    params = net.init(torch.Generator().manual_seed(args.seed), dtype=torch.float64)
    print("[3] served main path: pinn-pde DenseMLP(2, 32, 3, 1, tanh) f64, ntp/cuda")
    launches = serve_main_path(net, params, gen, report)

    print("[4] times (CUDA events, warm L2, back-to-back device work)")
    times = time_kernels(net, params, gen, report)
    time_server(net, params, gen, report)

    t = times["cross512"]
    kernels = []
    for name, source, replaces in (
            ("jet_dense", "src/repro_torch/kernels/csrc/jet_dense.cu",
             "src/repro/kernels/jet_dense.py:82"),
            ("act_jet", "src/repro_torch/kernels/csrc/act_jet.cu",
             "src/repro/kernels/tanh_jet.py:96")):
        k = t[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(worst[name], k["max_abs_err"]),
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "gemm_only_ms": k.get("gemm_only_ms"), "host_ms": k["host_ms"],
            "shape": t["shape"], "dtype": t["dtype"]})
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
