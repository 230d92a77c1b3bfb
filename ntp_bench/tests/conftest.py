"""Shrunken cells for the CPU: the same drivers, programs and references
at a size a test run holds.  ``ntp/cuda`` runs the kernels' plain versions
on CPU tensors."""

import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

CELLS = ("burgers-k4-train", "trunk-serve", "mlp-table-o10", "trunk-heat-train")


def small(name: str) -> dict:
    from ntp_bench.common import workload
    wl = copy.deepcopy(workload(name))
    if wl["driver"] == "adam_steps":
        o = wl["objective"]
        o["n_domain"] = 64
        if "n_origin" in o:
            o["n_origin"] = 16
        if "n_bc" in o:
            o["n_bc"] = 8
    elif wl["driver"] == "offline_tables":
        wl.update(rows=64, pool=2, sample=2)
    else:
        wl.update(buckets=[16, 32, 64], rows_min=8, rows_max=64, rate_per_s=8.0, sample=3)
    return wl


def run_small(name: str, seed: int = 2**33 + 7, seconds: float = 0.5, trace=False):
    import torch
    from ntp_bench.run import measure
    return measure(small(name), seed, seconds, trace, device=torch.device("cpu"),
                   t_start=time.monotonic())


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
