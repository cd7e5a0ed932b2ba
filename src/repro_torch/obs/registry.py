"""Serving metrics registry: counters, gauges, histograms and series
with NaN-safe percentile snapshots and Prometheus text and JSON exports
(port of ``repro/obs/registry.py``, the same formats byte for byte).

One registry backs the serving metrics of a scheduler: its ``alive_log``
and ``tick_log`` are views over ``Series``, and TTFT and per-token latency
land in ``Histogram``s at retire time; the CLIs add their gauges to it for
``--metrics-out``. Everything here is host work: observing a metric never
touches a device.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Series"]

DEFAULT_PERCENTILES = (50, 90, 99)

_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _PROM_NAME.sub("_", name)
    return n if not n[:1].isdigit() else "_" + n


class Counter:
    """Monotonically increasing total."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self.value += n

    def snapshot(self) -> Dict[str, Any]:
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Last-written value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> Dict[str, Any]:
        return {"type": self.kind, "value": self.value}


class Histogram:
    """Raw-sample histogram with NaN-safe percentile snapshots.

    Samples are kept exactly (serving traces are bounded, and exact
    percentiles beat bucket-quantization error at these sizes);
    ``percentiles`` matches ``np.percentile`` bit-for-bit on non-empty
    data and returns NaN, never raises, on empty data."""

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    def percentiles(self, ps: Iterable[float] = DEFAULT_PERCENTILES
                    ) -> Dict[float, float]:
        if not self.samples:
            return {p: float("nan") for p in ps}
        xs = np.asarray(self.samples, np.float64)
        return {p: float(np.percentile(xs, p)) for p in ps}

    def snapshot(self) -> Dict[str, Any]:
        if not self.samples:
            nan = float("nan")
            return {"type": self.kind, "count": 0, "sum": 0.0,
                    "mean": nan, "min": nan, "max": nan,
                    "percentiles": self.percentiles()}
        xs = np.asarray(self.samples, np.float64)
        return {"type": self.kind, "count": int(xs.size),
                "sum": float(xs.sum()), "mean": float(xs.mean()),
                "min": float(xs.min()), "max": float(xs.max()),
                "percentiles": self.percentiles()}


class Series:
    """Ordered (label, value) pairs — the registry type backing the
    schedulers' ``tick_log`` (label = tick kind, value = tokens) and
    ``alive_log`` (unlabeled). ``items``/``values`` return the LIVE
    backing lists so the legacy attributes stay exact aliases, not
    copies."""

    kind = "series"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._items: List[Tuple[Optional[str], float]] = []
        self._values: List[float] = []

    def append(self, value: float, label: Optional[str] = None) -> None:
        self._items.append((label, value))
        self._values.append(value)

    def __len__(self) -> int:
        return len(self._items)

    @property
    def items(self) -> List[Tuple[Optional[str], float]]:
        return self._items

    @property
    def values(self) -> List[float]:
        return self._values

    def snapshot(self) -> Dict[str, Any]:
        by_label: Dict[str, Dict[str, float]] = {}
        for lab, v in self._items:
            d = by_label.setdefault(lab if lab is not None else "",
                                    {"count": 0, "sum": 0.0})
            d["count"] += 1
            d["sum"] += float(v)
        return {"type": self.kind, "count": len(self._items),
                "by_label": by_label}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "series": Series}


class MetricsRegistry:
    """Named metric store with get-or-create accessors and two export
    formats (Prometheus text exposition / JSON)."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help)
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def series(self, name: str, help: str = "") -> Series:
        return self._get(Series, name, help)

    def names(self) -> Tuple[str, ...]:
        return tuple(self._metrics)

    # -- export -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {name: m.snapshot() for name, m in self._metrics.items()}

    def to_json(self, path: Optional[str] = None) -> str:
        txt = json.dumps(self.snapshot(), indent=1)
        if path:
            with open(path, "w") as f:
                f.write(txt + "\n")
        return txt

    def to_prometheus(self, path: Optional[str] = None) -> str:
        """Prometheus text exposition: counters/gauges verbatim,
        histograms as summaries (quantile labels + _sum/_count), series
        as per-label count/sum pairs."""
        lines: List[str] = []
        for name, m in self._metrics.items():
            pn = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pn} {m.help}")
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"# TYPE {pn} {m.kind}")
                lines.append(f"{pn} {m.value}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {pn} summary")
                for p, v in m.percentiles().items():
                    q = p / 100.0
                    lines.append(f'{pn}{{quantile="{q}"}} '
                                 f"{v if not math.isnan(v) else 'NaN'}")
                snap = m.snapshot()
                lines.append(f"{pn}_sum {snap['sum']}")
                lines.append(f"{pn}_count {snap['count']}")
            else:                                   # Series
                lines.append(f"# TYPE {pn} counter")
                snap = m.snapshot()
                for lab, d in snap["by_label"].items():
                    sel = f'{{label="{lab}"}}' if lab else ""
                    lines.append(f"{pn}_count{sel} {d['count']}")
                    lines.append(f"{pn}_sum{sel} {d['sum']}")
        txt = "\n".join(lines) + "\n"
        if path:
            with open(path, "w") as f:
                f.write(txt)
        return txt
