"""Readings that set a cell's limits: the program's compared numbers over
many seeds, read in one process, beside those of the control (the
reference put in the program's place at a lower precision) and of faults
planted in it. Not part of a benchmark run.

  python3 bench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 10 \\
      [--control fp8] [--faults half_batch] [--program 0]

Prints one JSON line per seed and reading.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import run as R
    from bench.lib import common
    R._environment()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--faults", default="")
    ap.add_argument("--program", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    files = common.cell_files(args.workload)
    driver = common.load_module(common.BENCH / "drivers" / f"{files['cell']['driver']}.py")
    clock = common.Clock()
    for seed in (int(s) for s in args.seeds.split(",")):
        job = R.Job(args.workload, seed, args.seconds, 0, files, clock,
                    torch.device("cuda", 0), files["cell"]["chips"])
        job.control = args.control
        if args.program:
            out = driver.run(job)
            print(json.dumps({"seed": seed, "program": out["numbers"],
                              "control": out.get("control"), "e2e": out["e2e"]}), flush=True)
        if args.control and hasattr(driver, "control"):
            print(json.dumps({"seed": seed, "control": driver.control(job, kind=args.control)}),
                  flush=True)
        for fault in filter(None, args.faults.split(",")):
            print(json.dumps({"seed": seed, "fault": fault,
                              "reading": driver.control(job, fault=fault)}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
