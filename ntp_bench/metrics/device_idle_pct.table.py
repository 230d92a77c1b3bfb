"""The device's idle share of the traced window: the window less the union
of its kernel and copy intervals."""

from ntp_bench.metrics import idle_pct

MOVES = "table_rows_per_s"


def read(r):
    return idle_pct(r, "table")
