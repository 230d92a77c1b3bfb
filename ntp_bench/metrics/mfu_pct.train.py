"""The whole step's share of the card's peak: the model operations of the
window (3x the jet forward of each step, by the frozen counts of
ntp_bench/cost.py, whatever implements them) over the window's seconds
times 67 TFLOP/s."""

from ntp_bench.metrics import mfu_pct

MOVES = "train_step_ms"


def read(r):
    return mfu_pct(r, "train")
