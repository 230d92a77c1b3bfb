"""The device's idle share of the traced window: the window less the union
of its kernel and copy intervals."""

from ntp_bench.metrics import idle_pct

MOVES = "train_step_ms"


def read(r):
    return idle_pct(r, "train")
