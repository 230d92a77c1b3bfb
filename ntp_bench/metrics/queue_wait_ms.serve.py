"""Mean queue wait of the window's requests, from submit to the start of
their batch: the server's lifetime ``queue_wait`` total and count, read
before and after the window (serving/server.py)."""

MOVES = "serve_p95_ms"


def read(r):
    c = r.counters
    if r.kind != "serve" or not c.get("requests"):
        return None
    return 1e3 * c["queue_wait_s"] / c["requests"]
