"""The whole step's share of the card's peak: the model operations of the
window (the jet forward of each call, by the frozen counts of
ntp_bench/cost.py, whatever implements them) over the window's seconds
times 67 TFLOP/s."""

from ntp_bench.metrics import mfu_pct

MOVES = "table_rows_per_s"


def read(r):
    return mfu_pct(r, "table")
