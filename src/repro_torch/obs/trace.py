"""Host-side span tracer with Chrome-trace/Perfetto export (port of
``repro/obs/trace.py``).

One tracer serves the whole process: the Trainer's chunk execute/fetch
phases, the Prefetcher's produce/wait pair (on its worker thread) and the
serving schedulers' tick phases all record into it. Events live in host
memory as plain tuples until ``export`` writes the Chrome trace-event
JSON (load the file at https://ui.perfetto.dev or chrome://tracing).

  * ONE clock. ``monotonic()`` (``time.perf_counter``) is the port's
    only measurement clock: arrivals, admission, first-token and finish
    times and span durations all read it.
  * Near-zero cost when disabled: ``span`` on a disabled tracer returns a
    shared no-op context manager after one attribute check (no object,
    no clock read, no event).
  * No device work. Recording touches only the clock and a list append,
    so instrumented code stays green under ``analysis.hostsync``; span
    arguments must already be host scalars (never tensors: formatting
    one would pull it to the host).
  * Threads: ``list.append`` is atomic under the GIL and each event
    carries its thread's id; ``export`` maps the ids to dense track
    numbers with ``thread_name`` metadata.

Device timeline: ``annotation`` names a region on a ``torch.profiler``
trace (``record_function``) and ``profile_window`` opens such a trace
(CPU and CUDA activities) written under a log directory.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Tracer", "get_tracer", "monotonic", "set_tracer"]


def monotonic() -> float:
    """Monotonic seconds (perf_counter): durations and same-process
    orderings only."""
    return time.perf_counter()


class _NullCtx:
    """Shared no-op context manager: the disabled tracer's fast path."""
    __slots__ = ()

    def __enter__(self) -> "_NullCtx":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullCtx()


class _Span:
    """One open span; records a complete ('X') event on exit."""
    __slots__ = ("_tr", "_name", "_args", "_t0")

    def __init__(self, tr: "Tracer", name: str, args: Dict[str, Any]):
        self._tr, self._name, self._args = tr, name, args

    def __enter__(self) -> "_Span":
        self._t0 = monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = monotonic()
        self._tr._record("X", self._name, self._t0, t1 - self._t0, self._args)
        return False


class _ProfileWindow:
    """A ``torch.profiler.profile`` window (CPU and, with a card, CUDA
    activities) whose Chrome trace is written under ``logdir`` on exit;
    ``path`` names the file, ``profiler`` is the profile object."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path: Optional[str] = None
        self.profiler = None

    def __enter__(self) -> "_ProfileWindow":
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=acts)
        self.profiler.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profiler.__exit__(*exc)
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(
            self.logdir, f"profile_{os.getpid()}_{time.monotonic_ns()}.json")
        self.profiler.export_chrome_trace(self.path)
        return False


def _jsonable(v: Any) -> Any:
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


class Tracer:
    """Nested spans and instant events on the monotonic clock.

    ``span(name, **args)`` is a context manager (nesting = containment,
    stacked slices per thread); ``instant`` marks a point ('i' event, e.g.
    a prefix-cache hit); ``counter`` records a 'C' series. ``export(path)``
    writes ``{"traceEvents": [...]}`` with ``ts`` and ``dur`` in µs since
    the tracer's epoch."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._epoch = monotonic()
        self._events: List[Tuple[str, str, float, float, int,
                                 Dict[str, Any]]] = []
        self._tid_names: Dict[int, str] = {}
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------

    def _record(self, ph: str, name: str, ts: float, dur: float,
                args: Dict[str, Any]) -> None:
        tid = threading.get_ident()
        if tid not in self._tid_names:
            self._tid_names[tid] = threading.current_thread().name
        self._events.append((ph, name, ts, dur, tid, args))

    def span(self, name: str, **args):
        """Context manager timing the enclosed block. A disabled tracer
        returns a shared no-op after one attribute check."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self._record("i", name, monotonic(), 0.0, args)

    def counter(self, name: str, **values) -> None:
        if not self.enabled:
            return
        self._record("C", name, monotonic(), 0.0, values)

    # -- device-timeline hooks ---------------------------------------------

    def annotation(self, name: str):
        """Name the enclosed region on a ``torch.profiler`` timeline
        (``record_function``): only seen inside a profiler window; the
        null context when the tracer is disabled."""
        if not self.enabled:
            return _NULL
        from torch.profiler import record_function
        return record_function(name)

    def profile_window(self, logdir: Optional[str]):
        """A ``torch.profiler`` window writing a Chrome trace of the
        enclosed host and device activity under ``logdir``, beside this
        tracer's host spans; the null context without a ``logdir`` or
        when the tracer is disabled."""
        if not self.enabled or not logdir:
            return _NULL
        return _ProfileWindow(logdir)

    # -- inspection / export ------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    @property
    def events(self) -> List[Tuple[str, str, float, float, int,
                                   Dict[str, Any]]]:
        """Raw (ph, name, t_start, dur, tid, args) tuples in record order
        (seconds on the monotonic clock)."""
        return list(self._events)

    def durations(self, name: str) -> List[float]:
        """Seconds of every completed span called ``name``."""
        return [e[3] for e in self._events if e[0] == "X" and e[1] == name]

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._tid_names = {}
            self._epoch = monotonic()

    def export(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Chrome trace-event JSON object; written to ``path`` if given.

        Spans become complete ('X') events with ``ts``/``dur`` in µs;
        instants carry thread scope (``"s": "t"``); each thread gets a
        ``thread_name`` metadata event so Perfetto labels its track."""
        with self._lock:
            evs = list(self._events)
            names = dict(self._tid_names)
        dense: Dict[int, int] = {}
        for e in evs:
            dense.setdefault(e[4], len(dense))
        pid = os.getpid()
        out: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": "repro"}}]
        for tid, dt in dense.items():
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": dt,
                        "args": {"name": names.get(tid, f"thread-{dt}")}})
        for ph, name, ts, dur, tid, args in evs:
            ev: Dict[str, Any] = {
                "ph": ph, "name": name, "pid": pid, "tid": dense[tid],
                "ts": (ts - self._epoch) * 1e6,
                "args": {k: _jsonable(v) for k, v in args.items()}}
            if ph == "X":
                ev["dur"] = dur * 1e6
            elif ph == "i":
                ev["s"] = "t"
            out.append(ev)
        doc = {"traceEvents": out, "displayTimeUnit": "ms"}
        if path:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


# ---------------------------------------------------------------------------
# process-global tracer (disabled by default)
# ---------------------------------------------------------------------------
# Instrumented code (Trainer, Prefetcher, schedulers) picks this up when no
# tracer is passed, so `--trace-out` in a launcher turns on every layer.

_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    global _GLOBAL
    _GLOBAL = tracer
    return tracer
