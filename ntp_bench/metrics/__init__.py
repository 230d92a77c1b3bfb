"""Per-layer metrics, one reader a file: ``<metric>.py`` holds ``MOVES``
(the end-to-end metric it should move) and ``read(readings)``, which
returns the number or None where the run gives it nothing to read (no
trace, no work of that layer).  A share of a bound or of a peak is never
returned as 0 for want of a reading.  The helpers below read a
:class:`ntp_bench.common.Readings`."""

from __future__ import annotations

from ntp_bench import cost


def roofline_pct(r, family: str, kind: str):
    """The least time the window's layers of ``family`` could take on the
    card, over the device time of the kernels that computed them, in %."""
    if r.kind != kind or r.trace is None:
        return None
    spent = r.trace.family_s.get(family, 0.0)
    bound = sum(layer.bound_s * n for layer, n in r.layers if layer.family == family)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None


def mfu_pct(r, kind: str):
    """The work's operations over the window at the card's float64 peak, in %."""
    if r.kind != kind or r.window_s <= 0 or r.model_flops <= 0:
        return None
    return 100.0 * r.model_flops / (r.window_s * cost.PEAK_FLOPS["float64"])


def idle_pct(r, kind: str):
    """The traced window less the union of device intervals, in %."""
    if r.kind != kind or r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (r.trace.window_s - r.trace.busy_s) / r.trace.window_s


def per_unit(r, kind: str, value: float):
    if r.kind != kind or r.units <= 0:
        return None
    return value / r.units
