"""Serving metrics registry (the parts of ``repro/obs/registry.py`` the
schedulers use): histograms with NaN-safe percentiles, and series.

One registry backs the serving metrics of a scheduler: its ``alive_log``
is a view over a ``Series``, and TTFT and per-token latency land in
``Histogram``s at retire time. Everything here is host
work: observing a metric never touches a device. Counters, gauges,
snapshots and the Prometheus and JSON exports come with
``--metrics-out``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

import numpy as np

__all__ = ["Histogram", "MetricsRegistry", "Series"]

DEFAULT_PERCENTILES = (50, 90, 99)


class Histogram:
    """Raw-sample histogram. ``percentiles`` matches ``np.percentile`` on
    non-empty data and returns NaN, never raises, on empty data."""

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    def percentiles(self, ps: Iterable[float] = DEFAULT_PERCENTILES
                    ) -> Dict[float, float]:
        if not self.samples:
            return {p: float("nan") for p in ps}
        xs = np.asarray(self.samples, np.float64)
        return {p: float(np.percentile(xs, p)) for p in ps}


class Series:
    """Ordered values. ``values`` returns the live backing list, so views
    over it stay exact aliases."""

    kind = "series"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: List[float] = []

    def append(self, value: float) -> None:
        self._values.append(value)

    def __len__(self) -> int:
        return len(self._values)

    @property
    def values(self) -> List[float]:
        return self._values


class MetricsRegistry:
    """Named metric store with get-or-create accessors."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help)
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        return m

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def series(self, name: str, help: str = "") -> Series:
        return self._get(Series, name, help)
