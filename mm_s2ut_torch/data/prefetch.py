"""Background prefetch for host batch pipelines (stdlib only).

A copy of ``mm_s2ut/data/prefetch.py``: wav decode and collation run in a
daemon thread ``depth`` batches ahead of the training loop; an exception
there is raised on the consumer's side.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

_SENTINEL = object()


class PrefetchIterator:
    def __init__(self, iterable: Iterable[Any], depth: int = 2):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(depth, 1))
        self._err: Exception | None = None
        self._thread = threading.Thread(target=self._fill, args=(iter(iterable),), daemon=True)
        self._thread.start()

    def _fill(self, it: Iterator[Any]) -> None:
        try:
            for item in it:
                self._q.put(item)
        except Exception as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(iterable: Iterable[Any], depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(iterable, depth)
