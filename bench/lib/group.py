"""A cell over several ranks: one spawned process a rank (a chip each on
the card, gloo ranks on the CPU), joined through a rendezvous file in a
fresh directory under the temporary directory. Each rank runs its
driver's ``run_rank``; what each returns comes back to the parent, which
waits for every process to end and stops any that outlives the run."""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import traceback
from pathlib import Path
from typing import Any, List

JOIN_S = 120.0
POLL_S = 5.0


def _rank_main(driver_path: str, job, rank: int, n: int, init: str, out) -> None:
    try:
        from bench.lib import common
        drv = common.load_module(Path(driver_path))
        out.put((rank, "ok", drv.run_rank(job, rank, n, init)))
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, "error", traceback.format_exc()))


def run(job, driver_path: str, n: int, timeout_s: float) -> List[Any]:
    """Every rank's result, rank 0 first; raises on any rank's error."""
    ctx = mp.get_context("spawn")
    where = tempfile.mkdtemp(prefix="bench-group-")
    init = f"file://{os.path.join(where, 'rendezvous')}"
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(driver_path, job, r, n, init, out))
             for r in range(n)]
    results, errors = {}, []
    try:
        for p in procs:
            p.start()
        waited = 0.0
        while len(results) + len(errors) < n:
            try:
                rank, kind, value = out.get(timeout=POLL_S)
            except queue.Empty:
                waited += POLL_S
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results]
                if dead or waited >= timeout_s:
                    raise RuntimeError(f"ranks {dead or sorted(set(range(n)) - set(results))} "
                                       f"ended or sent nothing in {waited} s") from None
                continue
            if kind == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
            if errors:
                break
    finally:
        for p in procs:
            p.join(JOIN_S if not errors else 5.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(JOIN_S)
        shutil.rmtree(where, ignore_errors=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(n)]
