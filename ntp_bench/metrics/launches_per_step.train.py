"""Device kernels a step, from the trace: the host's dispatch load (pinn/,
optim/, autograd)."""

from ntp_bench.metrics import per_unit

MOVES = "train_step_ms"


def read(r):
    if r.trace is None:
        return None
    return per_unit(r, "train", float(r.trace.kernels))
