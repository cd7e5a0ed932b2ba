"""What the per-layer metric files share: each reads one number from a
run's records (the window's spans, the traced stretch's device summary,
the kernel calls' bounds, the model FLOPs of the window) or returns None
where the run has nothing to read."""
from __future__ import annotations

from typing import Dict, Iterable, Optional

from bench.lib.roofline import MODEL_PEAK_FLOPS


def spans(rec: Dict, name: str):
    return [e for e in rec.get("spans") or [] if e[1] == name]


def mfu(rec: Dict, seconds: str = "window_s") -> Optional[float]:
    """Model FLOPs of the window over its ``seconds`` (the window, or the
    time its ticks took) at the bf16 peak, in %."""
    if not rec.get("model_flops") or not rec.get(seconds):
        return None
    return 100.0 * rec["model_flops"] / (rec[seconds] * MODEL_PEAK_FLOPS)


def idle(rec: Dict) -> Optional[float]:
    """The share of the traced stretch in which no operation ran on the
    device, in %."""
    p = rec.get("profile")
    if not p or not p["window_s"] or not p["busy_s"]:
        return None
    return 100.0 * max(1.0 - p["busy_s"] / p["window_s"], 0.0)


def roofline(rec: Dict, wrappers: Iterable[str]) -> Optional[float]:
    """The least time of the traced stretch's calls of ``wrappers`` over
    their device time, in %. Where the trace holds fewer launches of a
    wrapper than calls were noted (the profiler can drop events at its
    start), that wrapper's bound is its mean per call times its launches."""
    p, b = rec.get("profile"), rec.get("bounds")
    if not p or not b:
        return None
    bound = dev = 0.0
    for w in wrappers:
        k = p["kernels"].get(w)
        calls = b.get(w)
        if not k or not calls or not k["seconds"]:
            continue
        bound += sum(calls) / len(calls) * k["launches"]
        dev += k["seconds"]
    return 100.0 * bound / dev if dev else None
