"""Shape bucketing for the derivative server.

Point counts are rounded up to a small fixed set of **buckets**: requests
are padded with zero rows to the smallest admissible bucket, the bound-call
cache is keyed on the bucket (not the raw N), and pad rows are sliced off
before results are returned.  Every row of the jet forward is
batch-independent (dense layers act row-wise), so padding does not change
the values of the live rows; the kernels see a handful of fixed shapes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# Powers of two keep the number of distinct launch shapes logarithmic in the
# largest admissible request while capping pad waste at <50% per launch.
DEFAULT_BUCKETS: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512)


class RequestTooLargeError(ValueError):
    """A single request exceeds the largest configured bucket."""


def pick_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket admitting ``n`` rows; typed error when none does."""
    if n < 1:
        raise ValueError(f"need at least one query point, got n={n}")
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    raise RequestTooLargeError(
        f"{n} query points exceed the largest bucket "
        f"({max(buckets)}); split the request or configure larger buckets")


def pad_to(x: torch.Tensor, bucket: int) -> torch.Tensor:
    """Zero-pad ``x`` (N, d_in) to (bucket, d_in); an exact fit is returned
    unchanged."""
    n = x.shape[0]
    if n == bucket:
        return x
    if n > bucket:
        raise ValueError(f"cannot pad {n} rows down to bucket {bucket}")
    pad = x.new_zeros((bucket - n,) + tuple(x.shape[1:]))
    return torch.cat([x, pad], dim=0)


def pad_fraction(n: int, bucket: int) -> float:
    """Fraction of the launch that is padding (0.0 on an exact fit)."""
    return (bucket - n) / bucket
