"""Quickstart of the PyTorch port: n-TangentProp in 30 lines.

    PYTHONPATH=src python examples/torch_quickstart.py                 # on the GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Computes f, f', ..., f^(8) of a tanh MLP in ONE forward pass through the
hand-written CUDA kernels (their plain versions on the CPU), checks them
against nested autodiff, and pushes a jet through a softmax.
"""

import argparse
import time

import torch

from repro_torch.core import baselines, init_mlp, ntp_derivatives
from repro_torch.core import jet as J
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to run on the CPU)")
    ap.add_argument("--order", type=int, default=8)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # the paper's standard PINN network: 3 hidden layers x 24 neurons, tanh
    params = init_mlp(torch.Generator().manual_seed(0), d_in=1, width=24, depth=3, d_out=1,
                      dtype=torch.float64, device=device)
    x = torch.linspace(-1.0, 1.0, 256, dtype=torch.float64, device=device)[:, None]

    n = args.order
    times = []
    for _ in range(2):          # the first call on the card builds the kernels
        t0 = time.perf_counter()
        derivs = ntp_derivatives(params, x, n, impl="cuda")   # (n+1, batch, 1): f, ..., f^(n)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    print(f"n-TangentProp: all {n + 1} derivatives in one pass "
          f"({times[1] * 1e3:.1f} ms; the first call took {times[0] * 1e3:.1f} ms)")

    # independent oracle: nested reverse-mode autodiff (the O(M^n) way)
    k = min(6, n)
    ref = baselines.nested_autodiff(params, x[:8], k)
    err = float((derivs[:k + 1, :8] - ref).abs().max())
    print(f"max |ntp - nested autodiff| over orders 0..{k}: {err:.2e}")

    # jets through a softmax work too (beyond the paper)
    g = torch.Generator().manual_seed(1)
    h, v = (torch.randn((2, 5, 16), generator=g, dtype=torch.float64).to(device)
            for _ in range(2))
    jet = J.softmax(J.seed(h, v, 4), axis=-1)
    print("4th directional derivative of softmax:", tuple(jet.coeffs[4].shape))
    return {"derivs": derivs, "autodiff_err": err}


if __name__ == "__main__":
    main()
