"""The whole step's share of the card's peak: the model operations of the
window (the jet forward of each request's real rows, by the frozen counts of
ntp_bench/cost.py, whatever implements them) over the window's seconds
times 67 TFLOP/s."""

from ntp_bench.metrics import mfu_pct

MOVES = "serve_p95_ms"


def read(r):
    return mfu_pct(r, "serve")
