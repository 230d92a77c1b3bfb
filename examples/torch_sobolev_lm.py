"""n-TangentProp for transformers with the PyTorch port: Sobolev-regularized
LM training.

    PYTHONPATH=src python examples/torch_sobolev_lm.py --order 3 --steps 20
    PYTHONPATH=src python examples/torch_sobolev_lm.py --steps 3 --device cpu

TangentProp (the 1991 original) penalized first derivatives along invariance
directions; the quasilinear n-jet makes ORDER-n smoothness penalties on a
*transformer* affordable: one extra forward pass carrying an (n+1)-deep
Taylor stack through attention/softmax/GeGLU, instead of n nested autodiff
sweeps.  This trains a small dense LM with loss

    CE + coef * || d^n h / dt^n ||^2,   t -> embeddings + t v

and prints both terms; watch the smoothness term fall while CE trains.
Runs on the GPU unless ``--device cpu`` is given.
"""

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCfg
from repro_torch.data.tokens import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.launch.ntp_reg import ntp_smoothness
from repro_torch.models import init_model, train_loss
from repro_torch.optim import adam_init, adam_update
from repro_torch.tree import leaves, unflatten


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--coef", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    shape = ShapeCfg("sobolev", args.seq, args.batch, "train")
    params = init_model(cfg, 0, device=device)
    opt = adam_init(params)

    history = {"ce": [], "smooth": []}
    for i in range(args.steps):
        t0 = time.perf_counter()
        batch = synthetic_batch(cfg, shape, i, device=device)
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        p = unflatten(params, flat)
        ce, _ = train_loss(p, cfg, batch)
        smooth = ntp_smoothness(p, cfg, batch, args.order)
        grads = torch.autograd.grad(ce + args.coef * smooth, flat)
        params, opt = adam_update(unflatten(params, list(grads)), opt, params, 1e-3,
                                  grad_clip=1.0)
        history["ce"].append(float(ce.detach()))
        history["smooth"].append(float(smooth.detach()))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  ce={history['ce'][-1]:.4f}  "
                  f"||d^{args.order}h||^2={history['smooth'][-1]:.4e}  "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
    return history


if __name__ == "__main__":
    main()
