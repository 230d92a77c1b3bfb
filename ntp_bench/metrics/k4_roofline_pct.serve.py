"""The attention jets' share of their bound: the frozen bound of the
attention layers at the cell's rows and order (ntp_bench/cost.py), over
the device time of K4's kernels (``jet_flash_attention_short_kernel``,
``jet_flash_attention_long_kernel`` and the ``jet_flash_attention_rt*``
kernels; kernels/csrc/jet_flash_attention.cu, jet_runtime.cu)."""

from ntp_bench.metrics import roofline_pct

MOVES = "serve_p95_ms"


def read(r):
    return roofline_pct(r, "K4", "serve")
