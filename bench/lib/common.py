"""Run plumbing shared by the drivers: the files a cell is made of, the
clock, the statistics of a window, and the result line.

Everything a cell needs is found by name: ``workloads/<cell>.json``
names its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and its driver (``drivers/<driver>.py``);
``BENCHMARK.json`` at the checkout's root lists the metrics each cell
reports, and each per-layer metric is read by ``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# top-level module names that no process of the benchmark may hold: JAX,
# its libraries and the JAX package of this repository (compared whole:
# the port's name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def cell_files(name: str, bench: Path = BENCH) -> Dict[str, Dict[str, Any]]:
    """The cell ``name`` and the configuration and traffic mix it names."""
    cell = load_json(bench / "workloads" / f"{name}.json")
    return {"cell": cell,
            "config": load_json(bench / "configs" / f"{cell['config']}.json"),
            "traffic": load_json(bench / "traffic" / f"{cell['traffic']}.json")}


def load_module(path: Path, name: Optional[str] = None):
    """A module from a file of the benchmark, by path (metric files carry
    dots in their names)."""
    spec = importlib.util.spec_from_file_location(
        name or f"bench_{path.stem.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(man: Dict[str, Any], cell: str, kind: str) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` metrics of ``man`` that cell
    ``cell`` reports: those listing it, and those with no list."""
    return [m for m in man[kind] if cell in m.get("workloads", [cell])]


def process_age_s() -> float:
    """Seconds since this process started (its start time in the kernel's
    process table, in clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)


class Clock:
    """``now()`` in seconds since the process started."""

    def __init__(self):
        self._t0 = time.perf_counter() - process_age_s()

    def now(self) -> float:
        return time.perf_counter() - self._t0


def forbidden_modules(modules: Iterable[str] = None) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN_MODULES})


# ---------------------------------------------------------------------------
# statistics of a window
# ---------------------------------------------------------------------------

def rate(work: float, seconds: float) -> float:
    """All the work of a window over all of its time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of every value, by linear interpolation
    between order statistics (numpy's default rule)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile as a share of the
    median (Python's ``statistics.quantiles``, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------

def emit(result: Dict[str, Any]) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line of standard output, its ``check`` key last."""
    check = result.get("check", {})
    for k, v in check.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    ordered = {k: result[k] for k in ("correct", "attempted", "failed",
                                      "metrics", "device", "breakdown")
               if k in result}
    ordered["check"] = check
    sys.stderr.flush()
    print(json.dumps(ordered), flush=True)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number the cell compares (those its file gives a limit) beside
    its limit; a limit with no number is an error of the cell's file."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"no reading for the limits of {missing}")
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}


def passes(check: Dict[str, Dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in check.values())


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    """The process's peak of allocated device memory (0 off a card)."""
    import torch
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def seed_stream(seed: int, stream: int) -> int:
    """A 63-bit seed of stream ``stream`` of the run's ``--seed``."""
    return (int(seed) * 0x9E3779B1 + 0x632BE59BD9B4E019 * (stream + 1)) % (1 << 63)
