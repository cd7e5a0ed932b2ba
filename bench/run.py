"""The benchmark of the PyTorch/CUDA port: one run of one cell.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's chips. The last
line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
the compared numbers beside their limits under ``check``); the compared
numbers are also the last lines of standard error. With ``--trace 0``
the metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones, as ``BENCHMARK.json`` lists them. A run without the
chips it needs, or that finds JAX or the JAX package loaded once its
window has closed, prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench-cache"


def _environment() -> None:
    """Compile caches at fixed paths inside the checkout; no JAX through
    a library that would load it by itself."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Job:
    """What a driver is given: the run's arguments, the cell's files, the
    clock (seconds since the process started), the device and the chips."""

    def __init__(self, name, seed, seconds, trace, files, clock, device, chips):
        self.name, self.seed, self.seconds, self.trace = name, int(seed), float(seconds), bool(trace)
        self.files, self.clock, self.device, self.chips = files, clock, device, chips
        self.control = None     # a lower precision to read beside the program

    def log(self, msg: str) -> None:
        """A line of progress on standard error, at seconds since start."""
        print(f"[{self.clock.now():9.3f}] {msg}", file=sys.stderr, flush=True)


def run_job(job: Job, man) -> dict:
    """The result of one run, from the cell's driver and metric readers."""
    from bench.lib import common
    cell = job.files["cell"]
    driver = common.load_module(common.BENCH / "drivers" / f"{cell['driver']}.py")
    out = driver.run(job)
    job.log(f"readings: {out['numbers']}")
    check = common.judge(out["numbers"], cell["limits"])
    metrics = {}
    if job.trace:
        for m in common.metrics_of(man, job.name, "per_layer"):
            reader = common.load_module(common.BENCH / "metrics" / f"{m['name']}.py")
            value = reader.read(out["records"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in common.metrics_of(man, job.name, "end_to_end"):
            value = out["e2e"][m["name"]]
            if value is None:
                raise RuntimeError(f"{m['name']}: the window gave nothing to read")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu",
              "kind": _device_name(job.device),
              "count": job.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": common.passes(check), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device,
              "check": check}
    prof = out.get("profile")
    if job.trace and prof:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    return result


def _device_name(device) -> str:
    import torch
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None) -> int:
    _environment()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.lib import common
    clock = common.Clock()
    man = common.manifest()
    files = common.cell_files(args.workload)
    chips = files["cell"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    job = Job(args.workload, args.seed, args.seconds, args.trace, files, clock,
              torch.device("cuda", 0), chips)
    if job.trace:
        from bench.lib import trace
        trace.prime(job.device)
    result = run_job(job, man)
    bad = common.forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    common.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
