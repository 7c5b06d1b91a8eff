"""The prefetching input pipeline (counterpart of
``ct_icp_tpu/odometry/concurrent.py::PrefetchIterator``, :37-114).

A background thread walks the source and submits ``transform`` of each item
(frame rendering or loading, ``Odometry.prepare_frame``: host dedup and
packing) to a pool of :data:`WORKERS` threads, so that the streaming loop
only blocks on frames that are ready. Results are delivered in submission
order; numpy releases the GIL in its sorts, so the per-frame host work
spreads over cores.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

# the reference's prefetch pool on its streamed runs (PrefetchIterator(...,
# workers=3) in bench.py)
WORKERS = 3

_SENTINEL = object()


class PrefetchIterator:
    """Iterate ``source`` through ``transform`` with up to ``depth`` items
    prepared ahead, in order. An exception raised by the source or a
    transform is raised on the consumer side, where the item would have
    been delivered. ``close()`` (or the context-manager form) releases the
    worker pool; it is safe to call more than once."""

    def __init__(self, source: Iterable, transform: Callable,
                 depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._transform = transform
        self._exc: Optional[BaseException] = None
        self._pool = ThreadPoolExecutor(max_workers=WORKERS)
        self._thread = threading.Thread(
            target=self._worker, args=(iter(source),), daemon=True)
        self._thread.start()

    def _worker(self, it: Iterator):
        try:
            for item in it:
                # a bounded queue of futures is the backpressure; the
                # consumer resolves them in submission order
                self._queue.put(self._pool.submit(self._transform, item))
        except BaseException as e:  # raised on the consumer side
            self._exc = e
        finally:
            self._queue.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _SENTINEL:
            self.close()
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        try:
            return item.result()
        except BaseException:
            self.close()
            raise

    def close(self):
        """Release the transform pool (pending transforms are cancelled)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
