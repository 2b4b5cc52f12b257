"""Host-side batch prefetching.

The reference overlapped data loading with GPU compute via torch DataLoader
worker processes (train_meta.py:173-193). Here a daemon thread drives the
python/PIL pipeline one batch ahead while the step runs on the device; CUDA
launches return before the device finishes, so the thread's work overlaps
the step."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Run `iterable` in a background thread, buffering `depth` items.
    Exceptions propagate to the consumer at the matching position."""
    q: queue.Queue = queue.Queue(maxsize=depth)

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            q.put(_Raised(e))
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, _Raised):
            raise item.exc
        yield item
