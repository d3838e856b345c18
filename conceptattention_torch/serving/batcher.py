"""Micro-batching request queue for serving on one device.

Counterpart of the JAX package's `serving/batcher.py`, host code ported as
it is. `MicroBatcher` coalesces concurrent callers into batched calls:
callers `submit()` requests and get `concurrent.futures.Future`s; one worker
thread groups compatible requests (same `group_key`) up to `max_batch`,
waits at most `max_wait_ms` for stragglers, and calls `batch_fn(requests)
-> results` once per batch. That worker is the only thread that runs
`batch_fn`, so it is the one thread that drives the device. The HTTP server
pads each batch up to a size bucket (`next_bucket`), which keeps the set of
batch shapes small.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence


class QueueFullError(RuntimeError):
    """submit() refused: the queue already holds max_queue_depth requests.

    Admission control for overload: without a bound, sustained traffic above
    the device's throughput makes every request wait toward the request
    timeout (600 s by default) before failing — the server should fail fast
    (HTTP 503 + Retry-After) instead so clients back off while in-flight
    work still completes.
    """


@dataclasses.dataclass
class BatcherStats:
    """Cumulative counters, updated under the batcher lock."""

    requests_total: int = 0
    batches_total: int = 0
    errors_total: int = 0  # requests failed (batch_fn raised)
    rejects_total: int = 0  # submits refused by admission control
    batched_requests_total: int = 0  # sum of real (unpadded) batch sizes
    last_batch_size: int = 0
    # real (unpadded) batch size -> count; the coalescing histogram a load
    # test needs to see WHERE the batcher is operating, not just the mean
    batch_size_hist: dict = dataclasses.field(default_factory=dict)

    def snapshot(self) -> dict:
        d = dataclasses.asdict(self)
        if self.batches_total:
            d["mean_batch_size"] = round(
                self.batched_requests_total / self.batches_total, 3
            )
        return d


def next_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (the padded batch size), or n itself if it
    exceeds every bucket. Compiled-graph count stays at len(buckets)."""
    for b in sorted(buckets):
        if b >= n:
            return b
    return n


class MicroBatcher:
    """Coalesces concurrent submit()s into batched batch_fn calls.

    - `batch_fn(requests) -> results` runs on the single worker thread (the
      device dispatcher); it must return exactly one result per request.
    - `group_key(request)` partitions requests that can share a batch
      (e.g. same concepts/resolution/steps). Only the head-of-queue key is
      gathered per cycle; other keys wait for the next cycle — heterogeneous
      traffic serializes, matching the one-device execution model anyway.
    - A batch closes when `max_batch` compatible requests are queued or
      `max_wait_ms` has elapsed since its first request, whichever is first.
    """

    def __init__(
        self,
        batch_fn: Callable[[List[Any]], List[Any]],
        max_batch: int = 8,
        max_wait_ms: float = 25.0,
        group_key: Callable[[Any], Any] = lambda _request: None,
        name: str = "micro-batcher",
        max_queue_depth: Optional[int] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1 or None, got {max_queue_depth}"
            )
        self._batch_fn = batch_fn
        self._max_batch = max_batch
        self._max_queue_depth = max_queue_depth
        self._max_wait_s = max_wait_ms / 1000.0
        self._group_key = group_key
        self.stats = BatcherStats()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()  # (request, future)
        self._closed = False
        self._thread = threading.Thread(target=self._worker, name=name, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, request: Any) -> "Future":
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if (self._max_queue_depth is not None
                    and len(self._queue) >= self._max_queue_depth):
                self.stats.rejects_total += 1
                raise QueueFullError(
                    f"queue is full ({len(self._queue)} >= "
                    f"max_queue_depth {self._max_queue_depth})"
                )
            self._queue.append((request, fut))
            self.stats.requests_total += 1
            self._cv.notify()
        return fut

    @property
    def max_batch(self) -> int:
        return self._max_batch

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop accepting work; the worker drains already-queued batches,
        then exits. Blocks until drained by default (batches can run
        minutes on a device); with a `timeout`, requests still queued
        when it expires are failed."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)
        with self._cv:
            while self._queue:
                _, fut = self._queue.popleft()
                fut.set_exception(RuntimeError("MicroBatcher closed"))

    # ------------------------------------------------------------------
    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:  # closed and drained
                    return
                first = self._queue.popleft()
                key = self._group_key(first[0])
                batch = [first]
                deadline = time.monotonic() + self._max_wait_s
                while len(batch) < self._max_batch:
                    # Drain already-queued compatible requests, preserving
                    # arrival order of the ones left behind.
                    rest = []
                    while self._queue and len(batch) < self._max_batch:
                        item = self._queue.popleft()
                        if self._group_key(item[0]) == key:
                            batch.append(item)
                        else:
                            rest.append(item)
                    for item in reversed(rest):
                        self._queue.appendleft(item)
                    if len(batch) >= self._max_batch or self._closed:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
            self._dispatch(batch)

    def _dispatch(self, batch) -> None:
        requests = [r for r, _ in batch]
        try:
            results = self._batch_fn(requests)
            if len(results) != len(requests):
                raise RuntimeError(
                    f"batch_fn returned {len(results)} results for "
                    f"{len(requests)} requests"
                )
        except BaseException as e:  # noqa: BLE001 — forwarded to every future
            with self._lock:
                self.stats.batches_total += 1
                self.stats.errors_total += len(batch)
                self.stats.last_batch_size = len(batch)
                n = len(batch)
                self.stats.batch_size_hist[n] = (
                    self.stats.batch_size_hist.get(n, 0) + 1)
            for _, fut in batch:
                fut.set_exception(e)
            return
        with self._lock:
            self.stats.batches_total += 1
            self.stats.batched_requests_total += len(batch)
            self.stats.last_batch_size = len(batch)
            n = len(batch)
            self.stats.batch_size_hist[n] = (
                self.stats.batch_size_hist.get(n, 0) + 1)
        for (_, fut), res in zip(batch, results):
            fut.set_result(res)
