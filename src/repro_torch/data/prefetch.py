"""Background-thread data pipeline (port of ``repro/data/prefetch.py``,
without the reference's span tracer).

The Trainer consumes training data as CHUNKS: the per-step batches of K
consecutive steps stacked on a new leading axis. Chunk synthesis is pure
host work (vectorized numpy, ``repro_torch.data.pipeline``), so it
overlaps device compute: the ``Prefetcher`` maps a producer function over
a work list on a daemon thread into a depth-bounded queue (depth 2 =
double buffering: chunk c+1 is synthesized while the device runs chunk
c). The producer runs numpy only; device transfer happens on the consumer
side.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Tuple

import numpy as np

Batch = Dict[str, np.ndarray]


def stack_batches(batch_fn: Callable[[int], Batch], start: int, stop: int
                  ) -> Batch:
    """``batch_fn(i)`` for i in [start, stop), stacked on a new leading
    axis."""
    bs = [batch_fn(i) for i in range(start, stop)]
    return {k: np.stack([np.asarray(b[k]) for b in bs]) for k in bs[0]}


class Prefetcher:
    """Background-thread ``map(fn, items)`` with a bounded buffer.

    Iterating yields ``fn(item)`` in submission order. An exception in
    ``fn`` is re-raised at the consuming ``__next__``. ``close()`` stops
    the worker early (an abnormal consumer exit must never leave the
    thread blocked on a full queue, hence the put-with-timeout loop).
    """

    def __init__(self, fn: Callable[[Any], Any], items: Iterable[Any],
                 depth: int = 2):
        self._q: "queue.Queue[Tuple[str, Any]]" = queue.Queue(
            maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._fn = fn
        self._items = items
        self._done = False
        self._thread = threading.Thread(
            target=self._work, name="prefetcher", daemon=True)
        self._thread.start()

    def _put(self, msg: Tuple[str, Any]) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.1)
                return
            except queue.Full:
                continue

    def _work(self) -> None:
        try:
            for item in self._items:
                if self._stop.is_set():
                    return
                self._put(("ok", self._fn(item)))
            self._put(("end", None))
        except BaseException as e:  # noqa: BLE001 — surfaced to consumer
            self._put(("err", e))

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> Any:
        if self._done:
            raise StopIteration
        kind, val = self._q.get()
        if kind == "ok":
            return val
        self._done = True
        if kind == "err":
            raise val
        raise StopIteration

    def close(self) -> None:
        """Stop the worker and release its queue slot; idempotent."""
        self._stop.set()
        self._done = True
        try:  # unblock a worker waiting on a full queue
            self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
