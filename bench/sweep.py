"""The knee of a serving cell: its open loop at each of several rates, in
one process, each with a fresh scheduler. Not part of a benchmark run; a
benchmark PR runs it once when it sets a cell's rate (about four fifths of
the highest rate at which the queue does not grow).

  python3 bench/sweep.py --workload <cell> --rates 1,1.5,2 --seconds 20 --seed 7

Prints one JSON line per rate: the tails, the requests due in the window,
the queue at its close, and the median time to first token of the
window's first and last thirds (a queue that grows shows as the second far
above the first).
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import statistics
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
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    import torch
    files = common.cell_files(args.workload)
    driver = common.load_module(common.BENCH / "drivers" / f"{files['cell']['driver']}.py")
    clock = common.Clock()
    for rate in (float(r) for r in args.rates.split(",")):
        f = copy.deepcopy(files)
        f["traffic"]["rate"] = rate
        f["cell"]["check_requests"] = 1
        job = R.Job(args.workload, args.seed, args.seconds, 0, f, clock,
                    torch.device("cuda", 0), f["cell"]["chips"])
        seen = {}
        orig = driver._sample

        def keep(done, seed, n):
            seen["fin"] = done
            return orig(done, seed, n)

        driver._sample = keep
        out = driver.run(job)
        driver._sample = orig
        fin = seen["fin"]
        third = max(1, len(fin) // 3)
        ttft = [(r.first_token_at - r.arrival) * 1e3 for r in fin]
        print(json.dumps({"rate": rate, "e2e": out["e2e"], "requests": out["attempted"],
                          "failed": out["failed"],
                          "ttft_p50_first_third": statistics.median(ttft[:third]),
                          "ttft_p50_last_third": statistics.median(ttft[-third:]),
                          "numbers": out["numbers"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
