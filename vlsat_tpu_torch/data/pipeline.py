"""Host-side input prefetching (a copy of ``vlsat_tpu/data/pipeline.py``,
which imports no JAX).

The reference overlaps host preprocessing with device compute via 4
DataLoader worker processes (src/dataset/DataLoader.py:25-38).  Here a
daemon thread prepares upcoming batches while the accelerator runs the
current step — enough to hide the (native-accelerated) host prep behind
the device steps without multiprocessing.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class Prefetcher:
    """Wrap an iterable; pull items on a background thread."""

    def __init__(self, iterable: Iterable[T], depth: int = 2):
        self._iterable = iterable
        self.depth = depth

    def __iter__(self) -> Iterator[T]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        err: list[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self._iterable:
                    if not put(item):
                        return  # consumer stopped early
            except BaseException as e:  # propagate into the consumer
                err.append(e)
            finally:
                put(_SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # unblock and retire the worker if the consumer exits early
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=1.0)

    def __len__(self):
        return len(self._iterable)  # type: ignore[arg-type]
