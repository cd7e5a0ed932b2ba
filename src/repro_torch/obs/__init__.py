"""Observability of the serving loop (port of the parts of ``repro.obs``
the schedulers use): a host span tracer on one monotonic clock and a
metrics registry. Neither touches a device."""
from repro_torch.obs.registry import Histogram, MetricsRegistry, Series
from repro_torch.obs.trace import Tracer, get_tracer, monotonic

__all__ = ["Histogram", "MetricsRegistry", "Series", "Tracer", "get_tracer",
           "monotonic"]
