"""Serve a trained operator PINN with the PyTorch port: train -> checkpoint
-> hot derivative API.

    PYTHONPATH=src python examples/torch_serve_operator.py --op heat --steps 300
    PYTHONPATH=src python examples/torch_serve_operator.py --op kdv --order 3
    PYTHONPATH=src python examples/torch_serve_operator.py --clients 8 --points 40
    PYTHONPATH=src python examples/torch_serve_operator.py --device cpu

The end-to-end inference path: ``train_operator`` fits the PDE under
``ntp/cuda`` (the hand-written kernels), the parameters go through
``repro_torch.ckpt.CheckpointManager`` (an atomic step directory in the
format the JAX package writes too), and a
:class:`repro_torch.serving.DerivativeServer` restores them and serves
``(x, order)`` / ``(x, axes)`` queries for every engine spec of the port --
concurrent clients coalesce into shape-bucketed launches, bound calls are
cached per (engine, order, bucket), and each response carries
queue-wait/pad/cache metrics.  Served tables are checked against a direct
``engine.grid`` call before the per-spec metrics print.  Runs on the GPU
unless ``--device cpu`` is given.
"""

import argparse
import tempfile
import threading

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.core.engines import DerivativeEngine
from repro_torch.data.collocation import sample_box
from repro_torch.device import resolve_device
from repro_torch.pinn import (OperatorRunConfig, get_operator, operator_names,
                              train_operator)
from repro_torch.serving import DerivativeServer

# every engine spec of the port
SPECS = ("ntp", "ntp/cuda", "autodiff", "jet")


def serve_spec(ckpt_dir: str, net, spec: str, queries: list, order: int, device,
               mixed_axes=None) -> dict:
    """Restore the checkpoint into a server of ``spec``, answer one grid
    request per query from concurrent client threads (and one cross on
    ``mixed_axes``), and hold each table against a direct ``engine.grid``
    call on the server's parameters."""
    engine = DerivativeEngine.from_spec(spec)
    with DerivativeServer.from_checkpoint(ckpt_dir, net, engine=spec, dtype=torch.float64,
                                          flush_window_s=0.005, device=device) as server:
        results = [None] * len(queries)

        def client(i):
            results[i] = server.grid(queries[i], order, timeout=120.0)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        # every served table must agree with a direct engine call
        worst = 0.0
        with torch.no_grad():
            for x, table in zip(queries, results):
                direct = engine.grid(net, server.params, x, order)
                worst = max(worst, float((table - direct).abs().max()))
        mixed = server.cross(queries[0], mixed_axes, timeout=120.0) \
            if mixed_axes is not None else None
        return {"worst": worst, "mixed": mixed, "metrics": server.metrics(),
                "tables": results}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--op", default="heat", choices=list(operator_names()))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--order", type=int, default=None,
                    help="served derivative order (default: the operator's)")
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent client threads per engine spec")
    ap.add_argument("--points", type=int, default=24,
                    help="query points per client request")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temp dir)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    op = get_operator(args.op)
    order = args.order if args.order is not None else op.order
    print(f"training {op.name} (d_in={op.d_in}, d_out={op.d_out}) on {device} ...")
    cfg = OperatorRunConfig(op=args.op, width=args.width, depth=args.depth,
                            engine="ntp/cuda", adam_steps=args.steps,
                            log_every=max(args.steps // 4, 1))
    res = train_operator(cfg, device=device)
    net = res.net
    print(f"  trained: loss {res.loss_history[0]:.2e} -> "
          f"{res.loss_history[-1]:.2e}, L2 vs exact {res.l2_error:.2e}")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="serve_operator_")
    CheckpointManager(ckpt_dir).save(args.steps, res.params, blocking=True)
    print(f"  checkpointed to {ckpt_dir}")

    queries = [sample_box(torch.Generator().manual_seed(7 + i), op.domain, args.points,
                          torch.float64, device) for i in range(args.clients)]
    out = {"ckpt_dir": ckpt_dir, "result": res, "queries": queries, "order": order}
    for spec in SPECS:
        s = out[spec] = serve_spec(ckpt_dir, net, spec, queries, order, device,
                                   (0, 1) if op.d_in > 1 else None)
        m = s["metrics"]
        print(f"\nengine {spec}: served {m['requests']} requests in "
              f"{m['batches']} launches "
              f"(max |served - direct| = {s['worst']:.1e}"
              + (f"; u_xy head {s['mixed'][0].cpu().numpy()}" if s["mixed"] is not None
                 else "") + ")")
        print(f"  latency p50 {m['latency']['p50_us']:.0f}us "
              f"p99 {m['latency']['p99_us']:.0f}us | queue wait p50 "
              f"{m['queue_wait']['p50_us']:.0f}us | pad fraction "
              f"{m['pad_fraction_mean']:.2f}")
        c = m["cache"]
        print(f"  bound-call cache: {c['hits']} hits, {c['misses']} "
              f"misses, {c['evictions']} evictions, size {c['size']}")
    return out


if __name__ == "__main__":
    main()
