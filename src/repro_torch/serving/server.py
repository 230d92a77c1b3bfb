"""Batched high-order-derivative serving.

A :class:`DerivativeServer` holds one trained network + one derivative
engine and answers ``(x, order)`` / ``(x, axes)`` queries with derivative
tables.  The moving parts:

* requests enter a **bounded queue**; a full queue raises
  :class:`ServerOverloadedError` immediately (explicit backpressure);
* a worker thread waits one **flush window** after the first arrival so
  concurrent clients with the same (kind, order/axes, dtype) **coalesce
  into one launch**, concatenated and zero-padded to the smallest admissible
  bucket (see :mod:`repro_torch.serving.bucketing`);
* each (bucket, request) pair binds one engine call, cached with LRU
  eviction (:mod:`repro_torch.serving.cache`);
* every response carries per-request metrics (queue wait, pad fraction,
  cache hit, end-to-end latency) and the server aggregates p50/p99 over a
  sliding window (:class:`repro_torch.runtime.metrics.LatencyStats`).  On
  the card the worker synchronizes the device before it stamps a latency,
  so the numbers include the kernels' run, not only their enqueue.

Construction is direct (``DerivativeServer(net, params, "ntp/cuda")``) or
from a checkpoint the JAX package's ``ckpt.CheckpointManager`` wrote
(:meth:`DerivativeServer.from_checkpoint`, through :mod:`repro_torch.bridge`).
The server runs on the CUDA device unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as _FutureTimeout
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.bridge import load_jax_checkpoint, to_device
from repro_torch.core.engines import DerivativeEngine, EngineSpec
from repro_torch.core.network import Network
from repro_torch.device import resolve_device
from repro_torch.runtime.metrics import LatencyStats

from .bucketing import DEFAULT_BUCKETS, pad_fraction, pad_to, pick_bucket
from .cache import ExecutableCache, ExecutableKey


class ServerOverloadedError(RuntimeError):
    """The request queue is at capacity; retry with backoff."""


class RequestTimeoutError(TimeoutError):
    """The per-request deadline elapsed before a result was ready."""


class ServerClosedError(RuntimeError):
    """The server was closed while the request was pending."""


@dataclass(frozen=True)
class _GroupKey:
    """Requests coalesce only within a group: same computation, same dtype."""

    kind: str                  # "grid" | "cross"
    request: Tuple[int, ...]   # (order,) for grid, axes tuple for cross
    dtype: str


@dataclass
class ServedResult:
    """A derivative table plus the request's structured metrics.

    ``table`` is ``(d_in, order+1, N, d_out)`` for grid requests and
    ``(N, d_out)`` for cross requests, with N the caller's row count (pad
    rows are sliced off before delivery), on the server's device.
    """

    table: torch.Tensor
    queue_wait_s: float
    latency_s: float
    bucket: int
    batch_rows: int            # live rows in the coalesced launch
    pad_fraction: float
    cache_hit: bool


@dataclass
class _Pending:
    x: torch.Tensor
    group: _GroupKey
    future: Future
    t_submit: float


class DerivativeServer:
    """Serve ``engine.grid`` / ``engine.cross`` over a request queue.

    Parameters
    ----------
    net, params : the trained network and its parameter tree (moved to
        ``device``).
    engine : engine spec string ("ntp", "ntp/cuda", "autodiff") or a
        :class:`DerivativeEngine` instance.
    buckets : admissible padded batch sizes.
    flush_window_s : how long the batcher waits after the first request of a
        batch for more coalescible requests (0 disables coalescing).
    max_queue : queue-depth bound; submits beyond it raise
        :class:`ServerOverloadedError`.
    cache_capacity : LRU capacity of the bound-call cache.
    device : where the server computes; ``None`` is the CUDA device (raises
        without one).
    autostart : start the worker thread (tests drive :meth:`_drain_once`
        synchronously with ``autostart=False``).
    """

    def __init__(self, net: Network, params, engine="ntp", *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 flush_window_s: float = 0.002, max_queue: int = 256,
                 cache_capacity: int = 32, net_id: Optional[str] = None,
                 device=None, autostart: bool = True):
        self.device = resolve_device(device)
        self.net = net
        self.params = to_device(params, self.device)
        self.engine = DerivativeEngine.from_spec(engine)
        # the CANONICAL spec string keys the cache, so equivalent spellings
        # ("ntp" vs "ntp/torch") share one entry
        self.engine_spec = str(EngineSpec.parse(self.engine))
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets:
            raise ValueError("need at least one bucket size")
        self.flush_window_s = float(flush_window_s)
        self.max_queue = int(max_queue)
        self.net_id = net_id or (f"{type(net).__name__}"
                                 f"(d_in={net.d_in},d_out={net.d_out})")
        self.cache = ExecutableCache(capacity=cache_capacity)

        self._q: "deque[_Pending]" = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._worker: Optional[threading.Thread] = None

        self.queue_wait = LatencyStats()
        self.latency = LatencyStats()
        self._n_requests = 0
        self._n_batches = 0
        self._pad_sum = 0.0

        if autostart:
            self.start()

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def from_checkpoint(cls, directory: str, net: Network, *,
                        step: Optional[int] = None, dtype=torch.float64,
                        engine="ntp", device=None,
                        **kwargs) -> "DerivativeServer":
        """Restore ``net``'s parameters from a directory written by the JAX
        package's ``ckpt.CheckpointManager`` (latest step by default) and
        serve them."""
        device = resolve_device(device)
        params = load_jax_checkpoint(directory, net, step, dtype=dtype,
                                     device=device)
        return cls(net, params, engine, device=device, **kwargs)

    def start(self) -> None:
        if self._worker is None:
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="derivative-server")
            self._worker.start()

    def close(self) -> None:
        """Stop the worker; pending requests fail with ServerClosedError."""
        with self._cv:
            self._closed = True
            pending = list(self._q)
            self._q.clear()
            self._cv.notify_all()
        for item in pending:
            try:
                item.future.set_exception(
                    ServerClosedError("server closed before the request ran"))
            except InvalidStateError:
                pass                     # client already cancelled it
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def __enter__(self) -> "DerivativeServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- submit
    def submit(self, x, *, order: Optional[int] = None,
               axes: Optional[Sequence[int]] = None) -> Future:
        """Enqueue a request; returns a Future resolving to ServedResult.

        Exactly one of ``order`` (pure-derivative grid through that order)
        or ``axes`` (one mixed partial) must be given.
        """
        if (order is None) == (axes is None):
            raise ValueError("pass exactly one of order= or axes=")
        x = torch.as_tensor(x)
        if x.ndim != 2 or x.shape[1] != self.net.d_in:
            raise ValueError(f"x must be (N, {self.net.d_in}), "
                             f"got shape {tuple(x.shape)}")
        pick_bucket(x.shape[0], self.buckets)   # typed size/empty validation
        if order is not None:
            if order < 0:
                raise ValueError(f"order must be >= 0, got {order}")
            group = _GroupKey("grid", (int(order),), str(x.dtype))
        else:
            group = _GroupKey("cross", tuple(int(a) for a in axes),
                              str(x.dtype))

        item = _Pending(x=x.to(self.device), group=group, future=Future(),
                        t_submit=time.monotonic())
        with self._cv:
            if self._closed:
                raise ServerClosedError("server is closed")
            if len(self._q) >= self.max_queue:
                raise ServerOverloadedError(
                    f"request queue at capacity ({self.max_queue}); "
                    "shed load or raise max_queue")
            self._q.append(item)
            self._n_requests += 1
            self._cv.notify_all()
        return item.future

    def grid(self, x, order: int, *,
             timeout: Optional[float] = None) -> torch.Tensor:
        """Blocking pure-derivative table: (d_in, order+1, N, d_out)."""
        return self._result(self.submit(x, order=order), timeout).table

    def cross(self, x, axes: Sequence[int], *,
              timeout: Optional[float] = None) -> torch.Tensor:
        """Blocking mixed partial d^m f / dx_axes: (N, d_out)."""
        return self._result(self.submit(x, axes=axes), timeout).table

    @staticmethod
    def _result(future: Future, timeout: Optional[float]) -> ServedResult:
        try:
            return future.result(timeout)
        except _FutureTimeout:
            raise RequestTimeoutError(
                f"no result within {timeout}s (queue depth or a stalled "
                "launch; see server.metrics())") from None

    # -------------------------------------------------------------- worker
    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
            self._wait_flush_window()
            self._drain_once()

    def _wait_flush_window(self) -> None:
        """Give concurrent clients one window to coalesce; flush early when
        the queue already fills the largest bucket."""
        if self.flush_window_s <= 0:
            return
        deadline = time.monotonic() + self.flush_window_s
        with self._cv:
            while not self._closed:
                rows = sum(it.x.shape[0] for it in self._q)
                remaining = deadline - time.monotonic()
                if rows >= self.buckets[-1] or remaining <= 0:
                    return
                self._cv.wait(remaining)

    def _drain_once(self) -> bool:
        """Take one coalescible batch off the queue and execute it.

        Returns False when no batch ran (queue empty, or every admissible
        request had already been cancelled by its client).  The batch is the
        first live request plus every queued request sharing its group, in
        arrival order, up to the largest bucket; other groups stay queued
        for the next drain.  Requests a client cancelled while queued are
        dropped here -- fulfilling a cancelled future raises
        InvalidStateError, which would kill the worker thread.
        """
        with self._cv:
            batch, deferred, rows = [], [], 0
            while self._q:
                item = self._q.popleft()
                if batch and not (item.group == batch[0].group
                                  and rows + item.x.shape[0]
                                  <= self.buckets[-1]):
                    deferred.append(item)
                    continue
                if not item.future.set_running_or_notify_cancel():
                    continue             # cancelled while queued: drop
                batch.append(item)
                rows += item.x.shape[0]
            self._q.extend(deferred)
        if not batch:
            return False
        self._execute(batch)
        return True

    def _execute(self, batch: Sequence[_Pending]) -> None:
        t_batch = time.monotonic()
        group = batch[0].group
        ns = [it.x.shape[0] for it in batch]
        total = sum(ns)
        try:
            bucket = pick_bucket(total, self.buckets)
            xp = pad_to(torch.cat([it.x for it in batch], dim=0)
                        if len(batch) > 1 else batch[0].x, bucket)
            key = ExecutableKey(self.net_id, self.engine_spec, group.kind,
                                group.request, bucket, group.dtype)
            fn, hit = self.cache.get_or_build(key, lambda: self._bind(group))
            with torch.no_grad():
                out = fn(self.params, xp)
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
        except Exception as exc:                    # noqa: BLE001 -- fulfilled
            for it in batch:                        # per-request, not raised
                it.future.set_exception(exc)        # into the worker loop
            return

        frac = pad_fraction(total, bucket)
        with self._cv:
            self._n_batches += 1
            self._pad_sum += frac
        offset = 0
        for it, n in zip(batch, ns):
            seg = (out[:, :, offset:offset + n]
                   if group.kind == "grid" else out[offset:offset + n])
            offset += n
            now = time.monotonic()
            self.queue_wait.record(t_batch - it.t_submit)
            self.latency.record(now - it.t_submit)
            it.future.set_result(ServedResult(
                table=seg, queue_wait_s=t_batch - it.t_submit,
                latency_s=now - it.t_submit, bucket=bucket,
                batch_rows=total, pad_fraction=frac, cache_hit=hit))

    def _bind(self, group: _GroupKey):
        """The engine call for one request kind, as a callable of
        (params, padded x)."""
        engine, net = self.engine, self.net
        if group.kind == "grid":
            order = group.request[0]
            return lambda p, x: engine.grid(net, p, x, order)
        axes = group.request
        return lambda p, x: engine.cross(net, p, x, axes)

    # ------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        """Aggregated server metrics: request/batch counts, queue-wait and
        end-to-end latency snapshots (p50/p99), mean pad fraction, and the
        cache counters."""
        with self._cv:
            n_req, n_batch = self._n_requests, self._n_batches
            pad_sum, depth = self._pad_sum, len(self._q)
        return {
            "requests": n_req,
            "batches": n_batch,
            "queue_depth": depth,
            "queue_wait": self.queue_wait.snapshot(),
            "latency": self.latency.snapshot(),
            "pad_fraction_mean": (pad_sum / n_batch) if n_batch else 0.0,
            "cache": self.cache.stats(),
        }
