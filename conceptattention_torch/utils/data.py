"""Host-side input pipeline: threaded prefetch and device transfer overlap.

Counterpart of the JAX package's `utils/data.py`. A background thread pool
maps a load function over an index stream while the card computes, and
`prefetch_to_device` keeps the next batches already on their way to the
device: pinned host copies moved with `non_blocking=True`, so the copy of
batch i+1 overlaps the work on batch i. Works with any indexable dataset
(`evals/imagenet_data.ImageNetFolder`, `evals/datasets.ImagenetSegmentation`,
...) or any iterator of host batches.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Iterable, Iterator, Sequence, Union

import torch

from conceptattention_torch.models.flux.params import tree_map


class PrefetchIterator:
    """Background-thread prefetch over `fn(item)` for the items of `source`.

    Results arrive in order; at most `buffer_size` are computed or in flight,
    so memory stays bounded. An exception in a worker re-raises where its
    result is consumed."""

    def __init__(self, source: Iterable[Any], fn: Callable[[Any], Any] = lambda x: x,
                 buffer_size: int = 4, num_threads: int = 2):
        # A worker takes a slot before it pulls from the source and the
        # consumer gives it back on emit: at most buffer_size results exist
        # however slow the consumer is.
        self._slots = threading.Semaphore(max(1, buffer_size))
        self._src = iter(source)
        self._fn = fn
        self._lock = threading.Lock()  # serialises pulls from the source
        self._seq = 0
        self._emit = 0
        self._pending: dict = {}
        self._cv = threading.Condition()
        self._done = False
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max(1, num_threads))]
        for t in self._threads:
            t.start()

    def _worker(self):
        while True:
            self._slots.acquire()
            with self._lock:
                if self._done:
                    self._slots.release()
                    return
                try:
                    item = next(self._src)
                except StopIteration:
                    self._done = True
                    self._slots.release()
                    with self._cv:
                        self._cv.notify_all()
                    return
                seq = self._seq
                self._seq += 1
            try:
                result = (seq, self._fn(item), None)
            except Exception as e:  # re-raised by the consumer
                result = (seq, None, e)
            with self._cv:
                self._pending[seq] = result
                self._cv.notify_all()

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        with self._cv:
            while self._emit not in self._pending:
                if self._done and self._emit >= self._seq:
                    raise StopIteration
                self._cv.wait(timeout=0.1)
            _, value, err = self._pending.pop(self._emit)
            self._emit += 1
        self._slots.release()
        if err is not None:
            raise err
        return value

    def close(self):
        with self._lock:
            self._done = True
        # Workers wait on a slot when the buffer is full; one release wakes
        # one, and its own release on the `_done` branch wakes the next.
        self._slots.release()
        with self._cv:
            self._cv.notify_all()


def _to_device(x, device: torch.device):
    """A host leaf (numpy array or tensor) -> a tensor on `device`, through
    pinned memory with a non-blocking copy when the device is a card."""
    t = torch.as_tensor(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch_to_device(batches: Iterable[Any], size: int = 2,
                       device: Union[str, torch.device] = "cuda") -> Iterator[Any]:
    """Keep `size` batches (trees of dicts, lists and arrays) on their way to
    `device` ahead of the consumer."""
    dev = torch.device(device)
    buf: "collections.deque" = collections.deque()
    it = iter(batches)

    def put(x):
        return tree_map(lambda a: _to_device(a, dev), x)

    for x in it:
        buf.append(put(x))
        if len(buf) >= max(1, size):
            break
    while buf:
        out = buf.popleft()
        for x in it:
            buf.append(put(x))
            break
        yield out


def batched_indices(n: int, batch_size: int, drop_remainder: bool = False):
    """[0, n) -> lists of at most batch_size indices."""
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        if drop_remainder and len(idx) < batch_size:
            return
        yield idx


def make_loader(dataset, batch_size: int, collate: Callable[[Sequence[Any]], Any],
                buffer_size: int = 4, num_threads: int = 2, device_prefetch: int = 0,
                device: Union[str, torch.device] = "cuda") -> Iterator[Any]:
    """Indexable dataset -> iterator of collated batches loaded in the
    background, kept `device_prefetch` batches ahead on `device` when above 0."""
    def load(idx):
        return collate([dataset[i] for i in idx])

    it: Iterator[Any] = PrefetchIterator(batched_indices(len(dataset), batch_size), load,
                                         buffer_size=buffer_size, num_threads=num_threads)
    if device_prefetch > 0:
        it = prefetch_to_device(it, size=device_prefetch, device=device)
    return it
