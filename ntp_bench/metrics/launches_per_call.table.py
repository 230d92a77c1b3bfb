"""Device kernels a ``grid`` call, from the trace (core/engines.py,
core/network.py)."""

from ntp_bench.metrics import per_unit

MOVES = "table_rows_per_s"


def read(r):
    if r.trace is None:
        return None
    return per_unit(r, "table", float(r.trace.kernels))
