"""The dense tanh network: an input layer, ``depth - 1`` hidden layers
with the activation epilogue, and a linear readout, each a K1 layer."""

from __future__ import annotations

from ntp_bench import cost


def jet_forward(cfg: dict, rows: int, n1: int, readout_on_kernel: bool = True) -> list:
    """The readout is left out where the program computes it outside its
    kernels (``readout_on_kernel=False``)."""
    dt, w = cfg["dtype"], cfg["width"]
    out = [cost.dense(rows, cfg["d_in"], w, n1, True, dt)]
    out += [cost.dense(rows, w, w, n1, True, dt) for _ in range(cfg["depth"] - 1)]
    if readout_on_kernel:
        out.append(cost.dense(rows, w, cfg["d_out"], n1, False, dt))
    return out
