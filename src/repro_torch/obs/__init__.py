"""Observability of the port (port of ``repro.obs``).

Three parts, one invariant:

  * ``obs.trace``    -- host span tracer on the port's one monotonic
                        clock, Chrome-trace/Perfetto export, and
                        ``torch.profiler`` hooks for the device timeline;
  * ``obs.frame``    -- typed host view over the router/comm MetricsFrame
                        the train steps compute on the device;
  * ``obs.registry`` -- counters, gauges, histograms and series backing
                        the serving schedulers' stats, with Prometheus and
                        JSON export.

The invariant: observability adds no host-device sync. The frame rides
the chunk's one fetch; the tracer and the registry are host work
(``analysis.hostsync`` runs instrumented ticks and chunks to show it).
"""
from repro_torch.obs.frame import (FRAME_KEYS, MetricsFrame, load_imbalance,
                                   router_health)
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, Series)
from repro_torch.obs.trace import Tracer, get_tracer, monotonic, set_tracer

__all__ = [
    "Counter", "FRAME_KEYS", "Gauge", "Histogram", "MetricsFrame",
    "MetricsRegistry", "Series", "Tracer", "get_tracer", "load_imbalance",
    "monotonic", "router_health", "set_tracer",
]
