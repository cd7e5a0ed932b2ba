"""Host-side span tracer (the parts of ``repro/obs/trace.py`` the
schedulers use): one monotonic clock and nested spans whose durations are
recorded in host memory.

``monotonic()`` (``time.perf_counter``) is the one clock of the port's
serving loop: arrivals, admission, first-token and finish times and span
durations all read it. A disabled tracer's ``span`` returns a shared
no-op context manager after one attribute check. Recording touches only
the clock and a list append, never a device. Span arguments, instant
events and the Chrome-trace export come with ``--trace-out``.
"""
from __future__ import annotations

import time
from typing import List, Tuple

__all__ = ["Tracer", "get_tracer", "monotonic"]


def monotonic() -> float:
    """Monotonic seconds (perf_counter): durations and same-process
    orderings only."""
    return time.perf_counter()


class _NullCtx:
    __slots__ = ()

    def __enter__(self) -> "_NullCtx":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullCtx()


class _Span:
    """One open span; records its name and duration on exit."""
    __slots__ = ("_tr", "_name", "_t0")

    def __init__(self, tr: "Tracer", name: str):
        self._tr, self._name = tr, name

    def __enter__(self) -> "_Span":
        self._t0 = monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        self._tr._spans.append((self._name, monotonic() - self._t0))
        return False


class Tracer:
    """Nested spans on the monotonic clock."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._spans: List[Tuple[str, float]] = []

    def span(self, name: str):
        """Context manager timing the enclosed block."""
        if not self.enabled:
            return _NULL
        return _Span(self, name)

    def durations(self, name: str) -> List[float]:
        """Seconds of every completed span called ``name``."""
        return [dur for n, dur in self._spans if n == name]


_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process's tracer: disabled unless a caller passes its own."""
    return _GLOBAL
