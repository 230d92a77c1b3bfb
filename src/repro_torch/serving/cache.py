"""Bound-call cache for the derivative server.

Each distinct ``(network id, engine spec, grid|cross, order/axes, bucket,
dtype)`` tuple maps to one bound callable: the engine call specialized to
that request and shape.  PyTorch runs eagerly, so building an entry is
cheap, but the cache keeps the reference server's contract -- one entry per
launch shape, LRU eviction at a configurable capacity, hit/miss/eviction
counters for the metrics surface -- and is where a later slice hangs one
CUDA graph per bucket.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class ExecutableKey:
    """Everything that changes the bound computation.

    ``engine_spec`` must be the CANONICAL spec string
    (``str(repro_torch.core.engines.EngineSpec.parse(...))``), so equivalent
    spellings -- ``"ntp"`` vs ``"ntp/torch"`` -- share one entry;
    ``request`` is ``(order,)`` for a pure-derivative grid or the axes tuple
    for a mixed partial; ``bucket`` is the padded batch size; ``mesh`` is the
    data-parallel mesh the call is sharded over as ``((axis, size), ...)``
    pairs (empty for a single process: the same bucket sharded over another
    mesh is another call).
    """

    net_id: str
    engine_spec: str
    kind: str                 # "grid" | "cross"
    request: Tuple[int, ...]
    bucket: int
    dtype: str
    mesh: Tuple[Tuple[str, int], ...] = ()


class ExecutableCache:
    """LRU map ExecutableKey -> bound callable, with stats (thread-safe).

    ``get_or_build(key, builder)`` returns ``(callable, hit)``; the builder
    runs outside the lock only on a miss (a duplicate concurrent build is
    harmless: last writer wins, both callables are correct).
    """

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self._entries: "OrderedDict[ExecutableKey, Callable]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_build(self, key: ExecutableKey,
                     builder: Callable[[], Callable]) -> Tuple[Callable, bool]:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key], True
            self.misses += 1
        fn = builder()
        with self._lock:
            self._entries[key] = fn
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
        return fn, False

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: ExecutableKey) -> bool:
        with self._lock:
            return key in self._entries

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "size": len(self._entries),
                    "capacity": self.capacity}
