"""The dense-layer jets' share of their bound: the frozen bound of the
layers K1 computes at the cell's rows and order (ntp_bench/cost.py), over
the device time of K1's kernels (``jet_dense_kernel``,
``jet_dense_rt_kernel``; kernels/csrc/jet_dense.cu, jet_runtime.cu)."""

from ntp_bench.metrics import roofline_pct

MOVES = "table_rows_per_s"


def read(r):
    return roofline_pct(r, "K1", "table")
