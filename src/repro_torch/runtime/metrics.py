"""Latency/counter metrics shared by the runtime and serving layers.

A :class:`LatencyStats` is a thread-safe sliding-window reservoir of float
samples (seconds) with percentile snapshots -- the serving layer records
queue waits and end-to-end latencies into these, and :func:`percentile` is
the one quantile definition (linear interpolation, numpy's default) every
report uses.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Sequence

import numpy as np


def percentile(samples: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile of ``samples``; 0.0 when empty."""
    if not samples:
        return 0.0
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))


class LatencyStats:
    """Sliding-window latency reservoir (thread-safe).

    ``record`` keeps the last ``window`` samples for percentiles while the
    count/total accumulate over the full lifetime, so long-running servers
    report recent tail latency but exact request counts.
    """

    def __init__(self, window: int = 4096):
        self._samples: deque = deque(maxlen=window)
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))
            self.count += 1
            self.total += float(seconds)

    def snapshot(self) -> Dict[str, float]:
        """{count, mean_us, p50_us, p99_us} over the window (us = 1e-6 s)."""
        with self._lock:
            samples = list(self._samples)
            count, total = self.count, self.total
        return {
            "count": count,
            "mean_us": (total / count * 1e6) if count else 0.0,
            "p50_us": percentile(samples, 50) * 1e6,
            "p99_us": percentile(samples, 99) * 1e6,
        }
