"""Train a PINN on any registered differential operator, with the PyTorch
port.

    PYTHONPATH=src python examples/torch_pde_operator.py --op heat --steps 2000
    PYTHONPATH=src python examples/torch_pde_operator.py --op kdv --engine autodiff
    PYTHONPATH=src python examples/torch_pde_operator.py --op advection-diffusion \\
        --network fourier --fourier-features 32
    PYTHONPATH=src python examples/torch_pde_operator.py --op navier-stokes  # 4th-order psi_xxyy
    PYTHONPATH=src python examples/torch_pde_operator.py --op gray-scott     # d_out=2 system
    PYTHONPATH=src python examples/torch_pde_operator.py --op heat --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_pde_operator.py \\
        --op heat --devices 4 --grad-compression int8   # data-parallel, 4 GPUs

Each operator carries a manufactured/exact solution: it supplies the
boundary/initial data during training and the L2 accuracy oracle at the
end.  ``--engine`` is a derivative-engine spec: ``ntp/cuda`` (the default:
the hand-written kernels), ``ntp`` (the eager jet algebra), ``autodiff``
(nested autodiff, the paper's baseline) or ``jet`` (Taylor mode).
``--network`` picks any registered architecture: dense (paper), mlp,
residual, fourier, transformer.

``--devices N`` shards each collocation batch over the N ranks of a
process group (``OperatorRunConfig(data_parallel=N)``): launch N processes
with ``torchrun --nproc-per-node N``, each takes the GPU of its
``LOCAL_RANK`` (NCCL; gloo with ``--device cpu``).  Without such a group,
N > 1 is refused with that advice, and N = 1 says that it trains in one
process.  ``--grad-compression int8|topk:F`` routes the gradient
all-reduce through the port's error-feedback compressors (off by default:
the exact sum).  Runs on the GPU unless ``--device cpu`` is given.
"""

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.core import network_names
from repro_torch.device import resolve_device
from repro_torch.pinn import (OperatorRunConfig, get_operator, operator_names,
                              train_operator)


def parse_mask(text: str):
    """CLI spelling -> SelfAttention mask: none | causal | local:W."""
    text = text.strip().lower()
    if text in ("", "none"):
        return None
    if text == "causal":
        return "causal"
    if text.startswith("local:"):
        return ("local", int(text.split(":", 1)[1]))
    raise SystemExit(f"bad --mask {text!r}: expected none | causal | local:W")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--op", default="heat")
    ap.add_argument("--engine", default="ntp/cuda",
                    help="engine spec: ntp/cuda | ntp | autodiff | jet")
    ap.add_argument("--network", default="dense")
    ap.add_argument("--fourier-features", type=int, default=16,
                    help="embedding size for --network fourier")
    ap.add_argument("--heads", type=int, default=2,
                    help="attention heads for --network transformer "
                         "(--width must be divisible by it)")
    ap.add_argument("--mask", default="none",
                    help="attention mask for --network transformer: "
                         "none | causal | local:W (e.g. local:4)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--lbfgs", type=int, default=0)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--activation", default="tanh")
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--devices", type=int, default=0,
                    help="shard collocation batches over this many ranks of a "
                         "torchrun-started process group (0 = one process)")
    ap.add_argument("--grad-compression", default=None,
                    help="gradient all-reduce compression with --devices: "
                         "int8 | topk:F (default: the exact sum)")
    ap.add_argument("--points", type=int, default=1024,
                    help="collocation points per step (a multiple of --devices)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to run on the CPU)")
    return ap.parse_args(argv)


def join_process_group(devices: int, device: str | None):
    """(data_parallel, device, whether this call opened the group) for
    ``--devices``: the default group if one is open, else the one torchrun
    describes in the environment (this rank's GPU: ``LOCAL_RANK``)."""
    if devices <= 0:
        return 0, resolve_device(device), False
    opened = False
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        if device is None or torch.device(device).type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("gloo" if device == "cpu" else "nccl")
        opened = True
    if not dist.is_initialized():
        if devices > 1:
            raise SystemExit(
                f"--devices {devices} needs a process group of {devices} ranks: launch "
                f"with `torchrun --nproc-per-node {devices} examples/torch_pde_operator.py "
                f"--devices {devices} ...`")
        print("--devices 1 with no process group: training in one process, unsharded")
        return 0, resolve_device(device), False
    return devices, resolve_device(device), opened


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.op not in operator_names():
        raise SystemExit(f"unknown --op {args.op!r}; known: {', '.join(operator_names())}")
    if args.network not in network_names():
        raise SystemExit(f"unknown --network {args.network!r}; known: "
                         f"{', '.join(network_names())}")
    data_parallel, device, opened = join_process_group(args.devices, args.device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    op = get_operator(args.op)
    say(f"operator {op.name}: {op.description}")
    say(f"  d_in={op.d_in}, d_out={op.d_out}, "
        f"max pure-derivative order={op.order}, "
        f"mixed partials={op.mixed or 'none'}, domain={op.domain}")
    say(f"  engine={args.engine}, network={args.network}, device={device}, "
        f"data_parallel={data_parallel or 1}"
        + (f", grad_compression={args.grad_compression}" if args.grad_compression else ""))

    net_kwargs = {}
    if args.network == "fourier":
        net_kwargs["n_features"] = args.fourier_features
    elif args.network == "transformer":
        net_kwargs["n_heads"] = args.heads
        net_kwargs["mask"] = parse_mask(args.mask)
    cfg = OperatorRunConfig(op=args.op, engine=args.engine,
                            network=args.network, net_kwargs=net_kwargs,
                            adam_steps=args.steps, lbfgs_steps=args.lbfgs,
                            width=args.width, depth=args.depth,
                            activation=args.activation, adam_lr=args.lr,
                            n_domain=args.points, data_parallel=data_parallel,
                            grad_compression=args.grad_compression)
    try:
        res = train_operator(cfg, device=device)
    finally:
        if opened:
            dist.destroy_process_group()

    say(f"\nloss {res.loss_history[0]:.3e} -> {res.loss_history[-1]:.3e} "
        f"over {args.steps} Adam steps"
        + (f" + {args.lbfgs} L-BFGS steps" if args.lbfgs else ""))
    say(f"adam {res.adam_time_s:.1f}s, lbfgs {res.lbfgs_time_s:.1f}s, "
        f"{res.n_params} params")
    say(f"L2 error vs exact solution: {res.l2_error:.3e}")
    return {"result": res, "data_parallel": data_parallel}


if __name__ == "__main__":
    main()
