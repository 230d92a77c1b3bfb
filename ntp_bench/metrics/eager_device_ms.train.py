"""Device ms a step in kernels that are none of the port's five
``*_kernel`` symbols: the plain-jet backward, Adam and the glue (pinn/,
optim/, autograd)."""

from ntp_bench.metrics import per_unit

MOVES = "train_step_ms"


def read(r):
    if r.trace is None:
        return None
    return per_unit(r, "train", 1e3 * r.trace.family_s.get("eager", 0.0))
