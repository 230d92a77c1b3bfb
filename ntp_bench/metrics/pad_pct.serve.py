"""Mean share of padding rows in the window's batches (serving/bucketing.py):
the server's ``pad_fraction_mean`` times its batches, read before and
after the window."""

MOVES = "serve_p95_ms"


def read(r):
    c = r.counters
    if r.kind != "serve" or not c.get("batches"):
        return None
    return 100.0 * c["pad_sum"] / c["batches"]
