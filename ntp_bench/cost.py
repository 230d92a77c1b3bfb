"""The frozen yardstick: operations and bytes of the jet layers, the card's
peaks, and the layers a network's jet forward needs.

Copied at commit 52f33e389bd56e2b45464cb893c91d930ed51bc5 from
``chip_smoke.py`` (``PEAK_BYTES_S``, ``PEAK_FLOPS``, ``bound_ms``,
``kernel_cost``) and ``src/repro_torch/kernels/bell_tables.py``
(``flop_estimate`` over ``fdb_terms``, whose Faa di Bruno terms are the
integer partitions of each order).  The copies take shapes, not tensors,
and import nothing of the port, so a change to the port cannot move them.

Every count reads each input byte once and writes each output byte once,
whatever a kernel reads again, so no share of a bound can pass 100%.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from functools import lru_cache

# NVIDIA H100 SXM data sheet at 700 W: HBM3 bandwidth, and the float64
# tensor-core (= float32 FMA) rate that chip_smoke.py used for every dtype
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 67e12}
ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2}


@lru_cache(maxsize=None)
def partitions(k: int) -> tuple:
    """The integer partitions of ``k``, each a non-increasing tuple."""
    out = []

    def walk(rest, top, parts):
        if rest == 0:
            out.append(tuple(parts))
            return
        for p in range(min(rest, top), 0, -1):
            walk(rest - p, p, parts + [p])

    walk(k, k, [])
    return tuple(out)


def flop_estimate(n: int, batch: int, width: int) -> int:
    """Operations of one order-``n`` activation-jet epilogue on a
    (batch, width) tile: per output order k and per partition of k, 2 plus
    its number of parts, and the Horner rows 2 (m + 1) for m = 0..n."""
    per_elem = sum(2 + len(lam) for k in range(1, n + 1) for lam in partitions(k))
    horner = sum(2 * (m + 1) for m in range(n + 1))
    return (per_elem + horner) * batch * width


@dataclass(frozen=True)
class Layer:
    """One jet layer of a forward: the kernel family that computes it on
    the card ("K1" dense, "K3" rms_norm, "K4" flash attention), and what
    it must move and compute."""

    family: str
    nbytes: int
    flops: int
    dtype: str = "float64"

    @property
    def bound_s(self) -> float:
        return max(self.nbytes / PEAK_BYTES_S, self.flops / PEAK_FLOPS[self.dtype])


def dense(rows: int, din: int, dout: int, n1: int, act: bool, dtype: str) -> Layer:
    """K1: (n1, rows, din) x (din, dout) + bias, with the activation epilogue
    when ``act``."""
    item = ITEMSIZE[dtype]
    return Layer("K1", (n1 * rows * din + din * dout + dout + n1 * rows * dout) * item,
                 2 * n1 * rows * din * dout + rows * dout
                 + (flop_estimate(n1 - 1, rows, dout) if act else 0), dtype)


def rms_norm(rows: int, width: int, n1: int, dtype: str) -> Layer:
    """K3: the mean-square convolution, the rsqrt recurrence and the gain."""
    item = ITEMSIZE[dtype]
    return Layer("K3", (2 * n1 * rows * width + width) * item,
                 rows * width * (2 * n1 * (n1 + 1) + n1) + rows * n1 * n1, dtype)


def flash_attention(rows: int, heads: int, t: int, dh: int, dm: int, n1: int,
                    dtype: str) -> Layer:
    """K4: the score convolution, the exp and division recurrences, the
    value contraction and the output projection, no mask."""
    item = ITEMSIZE[dtype]
    pairs = rows * heads * t * t
    q = n1 * rows * heads * t * dh
    return Layer("K4", (3 * q + heads * dh * dm + n1 * rows * t * dm) * item,
                 pairs * (2 * n1 * (n1 + 1) * dh + 2 * n1 * n1)
                 + rows * heads * t * n1 * n1 * dh + rows * t * n1 * 2 * heads * dh * dm,
                 dtype)


def jet_forward(cfg: dict, rows: int, n1: int, readout_on_kernel: bool = True) -> list:
    """The jet layers one forward of the configuration's network needs on
    ``rows`` jets of ``n1`` coefficients, by the network's cost model
    (``cost_models/<network>.py``)."""
    model = importlib.import_module(f"ntp_bench.cost_models.{cfg['network']}")
    return model.jet_forward(cfg, rows, n1, readout_on_kernel)


def grid_rows(cfg: dict, n: int) -> int:
    """Jet rows of ``grid`` on n points: one direction per input axis."""
    return cfg["d_in"] * n


def cross_rows(n: int, m: int) -> int:
    """Jet rows of an m-axis ``cross`` on n points: 2^m polarization
    directions."""
    return (2 ** m) * n
