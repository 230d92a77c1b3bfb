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
from a checkpoint directory in the format both packages'
``ckpt.CheckpointManager`` write, whichever package wrote it
(:meth:`DerivativeServer.from_checkpoint`, through
:class:`repro_torch.ckpt.CheckpointManager`).
The server runs on the CUDA device unless ``device="cpu"`` is passed.

Data-parallel serving (``mesh=``, a :class:`repro_torch.parallel.DataMesh`):
construct the server on every rank of the mesh's process group.  Rank 0
takes the requests; for each bucketed batch it broadcasts a header (kind,
request, bucket, dtype) and the padded rows, every rank computes the
engine call on its contiguous shard of the bucket, and the table is
gathered.  The other ranks run a worker loop that serves those batches
until :meth:`DerivativeServer.close` on rank 0 ends it; their own
``close()`` waits for that.  While no request comes, rank 0 broadcasts an
idle header every ``heartbeat_s``, so the other ranks' wait for the next
header never outlives the process group's timeout.
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
import torch.distributed as dist

from repro_torch.bridge import load_jax_checkpoint, to_device
from repro_torch.core.engines import DerivativeEngine, EngineSpec
from repro_torch.core.network import Network
from repro_torch.device import resolve_device
from repro_torch.parallel.jet_shard import gather_rows, resolve_mesh
from repro_torch.runtime.metrics import LatencyStats

from .bucketing import DEFAULT_BUCKETS, pad_fraction, pad_to, pick_bucket
from .cache import ExecutableCache, ExecutableKey


class ServerOverloadedError(RuntimeError):
    """The request queue is at capacity; retry with backoff."""


class RequestTimeoutError(TimeoutError):
    """The per-request deadline elapsed before a result was ready."""


class ServerClosedError(RuntimeError):
    """The server was closed while the request was pending."""


# the header rank 0 broadcasts before each sharded batch: command, kind,
# bucket, dtype, request length, then the request (order or axes); while
# idle it broadcasts the command alone
_HEADER = 16
_STOP, _RUN, _IDLE = 0, 1, 2
_KINDS = ("grid", "cross")
_DTYPES = (torch.float64, torch.float32, torch.bfloat16, torch.float16)


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
    mesh : a :class:`repro_torch.parallel.DataMesh`; every bucket must be a
        multiple of its size, and the mesh shape joins every cache key (see
        the module docstring).
    heartbeat_s : under a mesh, the longest an idle rank 0 goes without a
        broadcast; keep it well under the process group's timeout (NCCL's
        default is 10 minutes, gloo's 30).
    autostart : start the worker thread (tests drive :meth:`_drain_once`
        synchronously with ``autostart=False``).
    """

    def __init__(self, net: Network, params, engine="ntp", *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 flush_window_s: float = 0.002, max_queue: int = 256,
                 cache_capacity: int = 32, net_id: Optional[str] = None,
                 device=None, mesh=None, heartbeat_s: float = 10.0,
                 autostart: bool = True):
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
        self.mesh = resolve_mesh(mesh) if mesh is not None else None
        if self.mesh is not None:
            bad = [b for b in self.buckets if b % self.mesh.size]
            if bad:
                raise ValueError(
                    f"buckets {bad} do not divide the {self.mesh.size}-way data "
                    f"axis; sharded launches need every padded batch to split evenly")
        self.mesh_key = tuple((str(a), int(n)) for a, n in self.mesh.shape.items()) \
            if self.mesh is not None else ()
        self.leader = self.mesh is None or self.mesh.rank == 0
        if not heartbeat_s > 0:
            raise ValueError(f"heartbeat_s must be > 0, got {heartbeat_s}")
        self.heartbeat_s = float(heartbeat_s)
        self.flush_window_s = float(flush_window_s)
        self.max_queue = int(max_queue)
        self.net_id = net_id or (f"{type(net).__name__}"
                                 f"(d_in={net.d_in},d_out={net.d_out})")
        self.cache = ExecutableCache(capacity=cache_capacity)

        self._q: "deque[_Pending]" = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._stopped = False
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
        """Restore ``net``'s parameters from a ``CheckpointManager``
        directory (latest step by default), whichever package wrote it, as
        ``dtype`` on ``device``, and serve them."""
        device = resolve_device(device)
        params = load_jax_checkpoint(directory, net, step, dtype=dtype,
                                     device=device)
        return cls(net, params, engine, device=device, **kwargs)

    def start(self) -> None:
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._run if self.leader else self._follow, daemon=True,
                name="derivative-server")
            self._worker.start()

    def close(self) -> None:
        """Stop the worker; pending requests fail with ServerClosedError.
        Under a mesh, rank 0's close also ends the other ranks' loops; on
        those ranks close waits for that."""
        if not self.leader:
            if self._worker is not None:
                self._worker.join()
                self._worker = None
            return
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
        if self.mesh is not None and not self._stopped:
            self._stopped = True
            self._broadcast_header()

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
        if not self.leader:
            raise RuntimeError(f"rank {self.mesh.rank} of a sharded server takes no "
                               "requests: submit them on rank 0")
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
                    if self.mesh is None:
                        self._cv.wait()
                    elif not self._cv.wait(self.heartbeat_s):
                        break
                if self._closed:
                    return
                idle = not self._q
            if idle:
                self._broadcast_header(_IDLE)
                continue
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
            fn, hit = self._bound(group, bucket)
            if self.mesh is None:
                with torch.no_grad():
                    out = fn(self.params, xp)
            else:
                self._broadcast_header(_RUN, group, bucket)
                dist.broadcast(xp.contiguous(), src=0, group=self.mesh.group)
                out = self._sharded(group, fn, xp)
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

    def _bound(self, group: _GroupKey, bucket: int):
        key = ExecutableKey(self.net_id, self.engine_spec, group.kind,
                            group.request, bucket, group.dtype, self.mesh_key)
        return self.cache.get_or_build(key, lambda: self._bind(group))

    # ------------------------------------------------------------- sharded
    def _broadcast_header(self, command: int = _STOP, group: Optional[_GroupKey] = None,
                          bucket: int = 0) -> torch.Tensor:
        """Rank 0 sends (and the other ranks receive) one header: a batch's
        (``_RUN``), ``_IDLE`` or ``_STOP`` (all zero)."""
        header = torch.zeros((_HEADER,), dtype=torch.int64, device=self.device)
        if self.leader:
            header[0] = command
        if self.leader and group is not None:
            req = group.request
            if len(req) > _HEADER - 5:
                raise ValueError(f"a sharded server takes requests of at most "
                                 f"{_HEADER - 5} entries, got {req}")
            names = [str(d) for d in _DTYPES]
            if group.dtype not in names:
                raise ValueError(f"a sharded server serves {names}, not {group.dtype}")
            dtype = names.index(group.dtype)
            header[:5 + len(req)] = torch.tensor(
                [command, _KINDS.index(group.kind), bucket, dtype, len(req), *req])
        dist.broadcast(header, src=0, group=self.mesh.group)
        return header

    def _sharded(self, group: _GroupKey, fn, xp: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the bucket through ``fn``, then the table
        gathered.  The ranks first agree that every shard ran (one
        all-reduce of a failure flag), so a failure on any rank fails the
        batch on rank 0 and no rank is left waiting in the gather."""
        size, rank = self.mesh.size, self.mesh.rank
        m = xp.shape[0] // size
        local, error = None, None
        try:
            with torch.no_grad():
                local = fn(self.params, xp[rank * m:(rank + 1) * m])
        except Exception as exc:                    # noqa: BLE001 -- reported below
            error = exc
        failed = torch.tensor([0 if error is None else 1], device=self.device)
        dist.all_reduce(failed, group=self.mesh.group)
        if int(failed) or error is not None:
            raise error if error is not None else RuntimeError(
                f"{int(failed)} rank(s) of the mesh failed this batch")
        return gather_rows(local, 2 if group.kind == "grid" else 0, self.mesh)

    def _follow(self) -> None:
        """The worker loop of a rank other than 0: serve rank 0's batches
        until its close."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            h = self._broadcast_header().tolist()
            if h[0] == _STOP:
                return
            if h[0] == _IDLE:
                continue
            group = _GroupKey(_KINDS[h[1]], tuple(h[5:5 + h[4]]), str(_DTYPES[h[3]]))
            xp = torch.empty((h[2], self.net.d_in), dtype=_DTYPES[h[3]], device=self.device)
            dist.broadcast(xp, src=0, group=self.mesh.group)
            fn, _ = self._bound(group, h[2])
            try:
                self._sharded(group, fn, xp)
            except Exception:                       # noqa: BLE001 -- rank 0 reports
                continue

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
