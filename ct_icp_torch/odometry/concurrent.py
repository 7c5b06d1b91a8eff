"""Concurrency utilities: the prefetching input pipeline, a blocking queue,
actors, pub-sub and a periodic scheduler (counterpart of
``ct_icp_tpu/odometry/concurrent.py``; reference
include/SlamCore/concurrent/blocking_queue.h:18-62,
include/SlamCore/reactors/{reactor.h,handler.h,scheduler.h},
include/ct_icp/reactors/).

:class:`PrefetchIterator`: a background thread walks the source and submits
``transform`` of each item (frame rendering or loading,
``Odometry.prepare_frame``: host dedup and packing) to a pool of
:data:`WORKERS` threads, so that the streaming loop only blocks on frames that
are ready. Results are delivered in submission order; numpy releases the
GIL in its sorts, so the per-frame host work spreads over cores.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional

# the reference's prefetch pool on its streamed runs (PrefetchIterator(...,
# workers=3) in bench.py)
WORKERS = 3

_SENTINEL = object()


class BlockingQueue:
    """Capacity-clamped blocking queue (reference blocking_queue.h:18-62)."""

    def __init__(self, capacity: int = 0):
        self._q = queue.Queue(maxsize=capacity)

    def push(self, item, timeout: Optional[float] = None):
        self._q.put(item, timeout=timeout)

    def pop(self, timeout: Optional[float] = None):
        return self._q.get(timeout=timeout)

    def __len__(self):
        return self._q.qsize()


def _identity(x):
    return x


class PrefetchIterator:
    """Iterate ``source`` through ``transform`` (none: the items as they
    are) with up to ``depth`` items prepared ahead, in order. An exception
    raised by the source or a transform is raised on the consumer side,
    where the item would have been delivered. ``close()`` (or the
    context-manager form) releases the worker pool; it is safe to call
    more than once."""

    def __init__(self, source: Iterable, transform: Optional[Callable] = None,
                 depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._transform = transform or _identity
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


class Notifier:
    """Pub-sub (reference Notifier/Observer)."""

    def __init__(self):
        self._observers: List[Callable] = []
        self._lock = threading.Lock()

    def subscribe(self, fn: Callable):
        with self._lock:
            self._observers.append(fn)

    def notify(self, *args, **kwargs):
        with self._lock:
            observers = list(self._observers)
        for fn in observers:
            fn(*args, **kwargs)


class Actor:
    """Message-driven actor with its own event-loop thread
    (reference GenericReactor + Handler, reactors/handler.h:17-60).

    Subclasses (or handler callables registered per message type) process
    messages serially — mutable state is confined to one thread.
    """

    def __init__(self):
        self._queue = BlockingQueue()
        self._handlers: Dict[type, Callable] = {}
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def register_handler(self, message_type: type, fn: Callable):
        self._handlers[message_type] = fn

    def send(self, message):
        self._queue.push(message)

    def react(self, message):
        handler = self._handlers.get(type(message))
        if handler is not None:
            handler(message)

    def _loop(self):
        while True:
            msg = self._queue.pop()
            if msg is _SENTINEL:
                break
            self.react(msg)

    def stop(self, join: bool = True):
        self._running = False
        self._queue.push(_SENTINEL)
        if join:
            self._thread.join(timeout=5)


class Scheduler:
    """Periodic callback thread (reference reactors/scheduler.h:17-71)."""

    def __init__(self, period_sec: float, fn: Callable):
        self.period = period_sec
        self.fn = fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.period):
            self.fn()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class RegistrationActor(Actor):
    """Async registration front-end (reference RegistrationReactor,
    ct_icp/reactors/registration.h:36-76): feed frames, observe summaries."""

    def __init__(self, odometry):
        super().__init__()
        self.odometry = odometry
        self.output = Notifier()
        self.register_handler(dict, self._on_frame)

    def _on_frame(self, frame: dict):
        summary = self.odometry.register_frame(
            frame["xyz"], frame["timestamps"], frame_id=frame.get("frame_id"))
        self.output.notify(summary)
