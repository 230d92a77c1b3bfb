"""Serving subsystem: bucketing, the bound-call cache, the microbatching
:class:`DerivativeServer` and its typed overload/timeout/closed errors."""

from .bucketing import (DEFAULT_BUCKETS, RequestTooLargeError, pad_fraction,
                        pad_to, pick_bucket)
from .cache import ExecutableCache, ExecutableKey
from .server import (DerivativeServer, RequestTimeoutError, ServedResult,
                     ServerClosedError, ServerOverloadedError)

__all__ = [
    "DEFAULT_BUCKETS", "DerivativeServer", "ExecutableCache",
    "ExecutableKey", "RequestTimeoutError", "RequestTooLargeError",
    "ServedResult", "ServerClosedError", "ServerOverloadedError",
    "pad_fraction", "pad_to", "pick_bucket",
]
