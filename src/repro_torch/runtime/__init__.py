"""Runtime helpers shared by the serving layer."""

from .metrics import LatencyStats, percentile

__all__ = ["LatencyStats", "percentile"]
