"""End-to-end driver of the PyTorch port: self-similar Burgers shock
profiles with a PINN (paper section IV-C + appendix A).

    PYTHONPATH=src python examples/torch_burgers_profile.py --k 1 --adam 1500 --lbfgs 300
    PYTHONPATH=src python examples/torch_burgers_profile.py --k 3      # 7 derivatives!
    PYTHONPATH=src python examples/torch_burgers_profile.py --k 1 --device cpu

Finds the k-th smooth profile (lambda = 1/2k) by the combined forward-inverse
procedure: constrain lambda to [1/(2k+1), 1/(2k-1)], penalize
|d^(2k+1) R / dX^(2k+1)| near the origin, train Adam -> L-BFGS.  The
default engine, ``ntp/cuda``, runs every hidden layer through the
hand-written kernel; ``--engine autodiff`` runs the identical schedule
with nested autodiff (the paper's baseline) for a wall-clock comparison.
Runs on the GPU unless ``--device cpu`` is given.
"""

import argparse

import numpy as np
import torch

from repro_torch.core.ntp import mlp_apply
from repro_torch.device import resolve_device
from repro_torch.pinn import PINNRunConfig, exact_profile, profile_lambda, train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=1, help="profile index (lam=1/2k)")
    ap.add_argument("--engine", choices=["ntp/cuda", "ntp", "autodiff", "jet"],
                    default="ntp/cuda", help="derivative-engine spec")
    ap.add_argument("--adam", type=int, default=1500)
    ap.add_argument("--lbfgs", type=int, default=300)
    ap.add_argument("--width", type=int, default=24)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = PINNRunConfig(k=args.k, engine=args.engine,
                        adam_steps=args.adam, lbfgs_steps=args.lbfgs,
                        width=args.width, depth=args.depth)
    print(f"profile k={args.k}: target lambda = {profile_lambda(args.k)} | "
          f"smoothness order = {cfg.k * 2 + 1} "
          f"(=> {cfg.k * 2 + 2} network derivatives) | engine={args.engine} | "
          f"device={device}")
    res = train(cfg, device=device)

    print(f"\nlambda learned = {res.lam:.6f}  (target {profile_lambda(args.k)})")
    print(f"adam {res.adam_time_s:.1f}s, lbfgs {res.lbfgs_time_s:.1f}s, "
          f"final loss {res.loss_history[-1]:.3e}")

    # accuracy against the closed-form profile (C=1 normalization)
    xs = np.linspace(-cfg.domain, cfg.domain, 401)
    u_true = exact_profile(xs, args.k)
    with torch.no_grad():
        u_net = mlp_apply(res.params, torch.tensor(xs, device=device)[:, None])[:, 0]
    l2 = float(np.sqrt(np.mean((u_net.cpu().numpy() - u_true) ** 2)))
    print(f"L2 error vs exact profile: {l2:.3e}")
    print("lambda history:", [f"{lam:.4f}" for lam in res.lam_history[-8:]])
    return {"result": res, "l2_error": l2}


if __name__ == "__main__":
    main()
