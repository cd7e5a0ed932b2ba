"""A ``torch.profiler`` window over a stretch of the run and what the
benchmark reads from its trace: device busy time (the union of kernel,
memcpy and memset intervals, a frozen copy of ``chip_smoke.py::busy_ms``),
device time of the port's kernels by wrapper and of NCCL's all-to-all
kernels, the device operations that
took most time, and the longest idle gaps of the device, each named by
what the host was doing when it began (the innermost host event open at
the gap's start)."""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from bench.lib.common import sync
from bench.lib.roofline import KERNELS

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("user_annotation", "cpu_op", "python_function", "cuda_runtime")
_KERNEL_RX = {name: re.compile(p) for name, p in KERNELS.items()}
# NCCL's all-to-all: grouped sends and receives (or its own kernel)
_A2A_RX = re.compile(r"nccl\w*(SendRecv|AllToAll)", re.IGNORECASE)


def wrapper_of(kernel: str) -> Optional[str]:
    for name, rx in _KERNEL_RX.items():
        if rx.search(kernel):
            return name
    return None


class Profile:
    """``with Profile(device) as p:`` traces the card's activity (kernels,
    copies, and the CUDA runtime calls that name the host's side of a gap;
    no host-op tracing, whose cost would widen the gaps of a host-bound
    step), the host's on the CPU; on exit (after a device sync)
    ``p.summary`` holds the reductions and the exported trace file is
    deleted."""

    def __init__(self, device):
        self.device = device
        self.summary: Dict = {}

    def __enter__(self) -> "Profile":
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA if self.device.type == "cuda"
                else ProfilerActivity.CPU]
        sync(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        sync(self.device)
        window = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.summary = reduce(events, window)
        return False


def prime(device) -> None:
    """Start the device profiler once on a trivial kernel, early in the
    process: on a fresh machine its first start in a process that has done
    much work since it began can fail to reach CUPTI and trace no device
    activity at all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        return
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        sync(device)


def reduce(events: List[Dict], window_s: float) -> Dict:
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        t0, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            dev.append((t0, t0 + dur, ev["name"], cat))
        elif cat in _HOST_CATS:
            host.append((t0, t0 + dur, ev["name"], cat))
    dev.sort()
    busy, end, gaps = 0.0, None, []
    by_name: Dict[str, float] = {}
    by_wrapper: Dict[str, Tuple[int, float]] = {}
    a2a = 0.0
    for a, b, name, cat in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if cat == "kernel" and _A2A_RX.search(name):
            a2a += (b - a) / 1e6
        if cat == "kernel":
            w = wrapper_of(name)
            if w is not None:
                n, s = by_wrapper.get(w, (0, 0.0))
                by_wrapper[w] = (n + 1, s + (b - a) / 1e6)
        if end is None:
            busy, end = b - a, b
            continue
        if a > end:
            gaps.append((a - end, end))
        if b > end:
            busy += b - max(a, end)
            end = b
    gaps.sort(reverse=True)
    return {"window_s": window_s, "busy_s": busy / 1e6,
            "device_span_s": ((dev[-1][1] - dev[0][0]) / 1e6) if dev else 0.0,
            "n_device_events": len(dev), "a2a_s": a2a,
            "kernels": {w: {"launches": n, "seconds": s}
                        for w, (n, s) in by_wrapper.items()},
            "device_ops": [[n[:120], s / 1e6] for n, s in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[_host_at(host, t), g / 1e6] for g, t in gaps[:10]]}


def _host_at(host: List[Tuple], t: float) -> str:
    """The innermost host event open at time ``t`` (the latest started one
    that has not ended), or "idle host"."""
    best = None
    for a, b, name, cat in host:
        if a <= t <= b and (best is None or a >= best[0]):
            best = (a, name, cat)
    return f"{best[2]}:{best[1][:80]}" if best else "idle host"
