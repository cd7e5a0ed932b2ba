"""Lint gate runner (port of ``repro/analysis/lint.py``): run every pass
over every registered executable, aggregate a report, gate CI.

The gate never raises on a violation: each (executable, pass) cell runs
independently so one broken invariant can't mask another; a crash while
BUILDING or running an executable becomes an "error" finding against
that executable (the gate must not silently skip a program that stops
running). ``gate()`` fails iff any unsuppressed error survives.

Executables of ``n_ranks`` > 1 run on every rank of one gloo group of
``n_ranks`` processes of this interpreter (``launch/lint.py --rank``),
started here and joined before the report; they rendezvous through a
file and rank 0 gathers the findings. On a card the ranks share it (gloo,
as phase ``tp`` of ``chip_smoke.py`` runs two ranks on one card). The
"static" passes, which ``--static-only`` and ``lint_table`` keep, are
every pass but ``host-sync``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.executables import (Artifacts, available_executables,
                                              get_executable)
from repro_torch.analysis.passes import (Finding, available_passes, get_pass,
                                         run_pass)

__all__ = ["LintRun", "cell_of", "check_device", "format_lint_table",
           "format_report", "gate", "lint_run", "lint_table", "rank_main",
           "report_json", "run_lint"]

RANK_TIMEOUT_S = 600
Cells = Dict[Tuple[str, str], List[Finding]]


def _applicable(spec, pass_id: str) -> bool:
    p = get_pass(pass_id)
    if "scenario" in p.needs:
        return spec.scenario is not None
    return pass_id in spec.expect


def _pass_ids(passes: Optional[Sequence[str]], static_only: bool) -> Tuple[str, ...]:
    pids = tuple(passes) if passes else available_passes()
    return tuple(p for p in pids if not (static_only and "scenario" in get_pass(p).needs))


def _crash(name: str, pid: str, e: BaseException) -> Finding:
    return Finding(pass_id=pid, severity="error", executable=name, location="gate",
                   message=f"pass crashed: {type(e).__name__}: {e}")


def _spec_cells(name: str, pids: Sequence[str], device, ctx=None,
                resources: Optional[Dict[str, Any]] = None) -> Cells:
    """Every applicable pass over one executable, from one run of it; the
    run's launches and kernels go into ``resources`` where given."""
    spec = get_executable(name)
    pids = [p for p in pids if _applicable(spec, p)]
    needs = {n for p in pids for n in get_pass(p).needs}
    art = Artifacts(spec, device, ctx=ctx, needs=needs)
    cells: Cells = {}
    for pid in pids:
        try:
            cells[(name, pid)] = run_pass(pid, spec, art)
        except Exception as e:           # build / run crash
            cells[(name, pid)] = [_crash(name, pid, e)]
    if resources is not None and art.resources():
        resources[name] = art.resources()
    return cells


def check_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device needs a card (no
    fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("lint on cuda: no CUDA device is visible")
    return device


class _Ranks:
    """The ``world`` processes of one gloo group running ``names`` x
    ``pids`` (started at construction); ``join`` returns rank 0's merged
    cells and every rank's resources (``{name: {"ranks": [...]}}``), or a
    crash finding per applicable cell if a rank failed."""

    def __init__(self, world: int, names: Sequence[str], pids: Sequence[str], device):
        self.names, self.pids = list(names), list(pids)
        self.tmp = tempfile.TemporaryDirectory(prefix="repro_lint_")
        d = self.tmp.name
        with open(os.path.join(d, "job.json"), "w") as f:
            json.dump({"names": self.names, "pids": self.pids,
                       "device": str(device), "world": world}, f)
        src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ, OMP_NUM_THREADS="1", LOCAL_RANK="0",
                   PYTHONPATH=os.pathsep.join(
                       [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                                if p]))
        # each rank's output to a file: a full pipe would stall a rank
        self.logs = [os.path.join(d, f"rank{r}.log") for r in range(world)]
        self.procs = []
        for r, log in enumerate(self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.lint", "--rank", str(r),
                     "--work-dir", d], stdout=f, stderr=subprocess.STDOUT, env=env))

    def join(self) -> Tuple[Cells, Dict[str, Any]]:
        try:
            try:
                for p in self.procs:
                    p.wait(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pass
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            out = os.path.join(self.tmp.name, "cells.json")
            failed = [r for r, p in enumerate(self.procs) if p.returncode != 0]
            if failed or not os.path.exists(out):
                r = failed[0] if failed else 0
                with open(self.logs[r]) as f:
                    log = f.read()
                err = RuntimeError(f"rank {r} of {len(self.procs)} exited "
                                   f"{self.procs[r].returncode}: {log[-3000:]}")
                return {(n, p): [_crash(n, p, err)] for n in self.names for p in self.pids
                        if _applicable(get_executable(n), p)}, {}
            with open(out) as f:
                doc = json.load(f)
            return ({(n, p): [Finding(**d) for d in fs] for n, p, fs in doc["cells"]},
                    doc["resources"])
        finally:
            self.tmp.cleanup()


def _merge_ranks(per_rank: List[Cells]) -> Cells:
    """One finding per distinct (pass, severity, location, message,
    suppressed) over the ranks, its location prefixed by the ranks that
    reported it."""
    out: Cells = {}
    for key in per_rank[0]:
        seen: Dict[Tuple, List[int]] = {}
        for r, cells in enumerate(per_rank):
            for f in cells.get(key, []):
                seen.setdefault((f.pass_id, f.severity, f.executable, f.location,
                                 f.message, f.suppressed), []).append(r)
        out[key] = [Finding(pass_id=k[0], severity=k[1], executable=k[2],
                            location=f"rank {','.join(map(str, rs))}: {k[3]}",
                            message=k[4], suppressed=k[5]) for k, rs in seen.items()]
    return out


def rank_main(rank: int, work_dir: str) -> int:
    """One rank of a lint group (``launch/lint.py --rank``): join the
    group, run the job's cells on this rank, and let rank 0 write every
    rank's, merged."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import close_group, make_group
    with open(os.path.join(work_dir, "job.json")) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    device = torch.device(job["device"])
    ctx = make_group((job["world"], 1), device, init_method=f"file://{work_dir}/rdv",
                     rank=rank, world_size=job["world"], backend="gloo")
    try:
        cells: Cells = {}
        resources: Dict[str, Any] = {}
        for name in job["names"]:
            cells.update(_spec_cells(name, job["pids"], device, ctx=ctx,
                                     resources=resources))
        gathered = [None] * job["world"] if rank == 0 else None
        dist.gather_object((cells, resources), gathered, dst=0)
        if rank == 0:
            merged = _merge_ranks([c for c, _ in gathered])
            per_rank = {name: {"ranks": [res.get(name) for _, res in gathered]}
                        for name in job["names"] if name in resources}
            with open(os.path.join(work_dir, "cells.json"), "w") as f:
                json.dump({"cells": [[n, p, [x.as_dict() for x in fs]]
                                     for (n, p), fs in merged.items()],
                           "resources": per_rank}, f, default=str)
    finally:
        close_group()
    return 0


@dataclasses.dataclass
class LintRun:
    """One run of the gate: the findings of every applicable (executable,
    pass) cell, and what each executable's run recorded
    (``Artifacts.resources``; a multi-rank one's per rank, ``{"ranks":
    [...]}``)."""
    cells: Cells
    resources: Dict[str, Any]

    @property
    def findings(self) -> List[Finding]:
        return [f for fs in self.cells.values() for f in fs]

    def table(self) -> Dict[str, Dict[str, str]]:
        """executable -> pass -> ``cell_of`` verdict, applicable cells only."""
        out: Dict[str, Dict[str, str]] = {}
        for (name, pid), fs in self.cells.items():
            out.setdefault(name, {})[pid] = cell_of(fs)
        return out


def lint_run(*, only: Optional[Sequence[str]] = None,
             passes: Optional[Sequence[str]] = None,
             static_only: bool = False, device="cuda") -> LintRun:
    """Every applicable (executable, pass) cell of the gate. ``only``
    restricts executables (exact names), ``passes`` restricts pass ids,
    ``static_only`` drops the scenario pass; ``device`` is where the
    executables run (a card unless told otherwise). The multi-rank
    executables run in a group of processes per rank count, started
    first, the others here meanwhile."""
    names = tuple(only) if only else available_executables()
    pids = _pass_ids(passes, static_only)
    device = check_device(device)
    by_world: Dict[int, List[str]] = {}
    for name in names:
        by_world.setdefault(get_executable(name).n_ranks, []).append(name)
    groups = [_Ranks(w, ns, pids, device) for w, ns in by_world.items() if w > 1]
    cells: Cells = {}
    resources: Dict[str, Any] = {}
    for name in by_world.get(1, []):
        cells.update(_spec_cells(name, pids, device, resources=resources))
    for g in groups:
        c, r = g.join()
        cells.update(c)
        resources.update(r)
    order = {n: i for i, n in enumerate(names)}
    return LintRun(dict(sorted(cells.items(), key=lambda kv: (order[kv[0][0]], kv[0][1]))),
                   resources)


def run_lint(*, only: Optional[Sequence[str]] = None,
             passes: Optional[Sequence[str]] = None,
             static_only: bool = False, device="cuda") -> List[Finding]:
    """The findings of ``lint_run``."""
    return lint_run(only=only, passes=passes, static_only=static_only,
                    device=device).findings


def gate(findings: Sequence[Finding]) -> Tuple[bool, str]:
    """(ok, one-line verdict): fails iff an unsuppressed error survives."""
    errs = [f for f in findings
            if f.severity == "error" and not f.suppressed]
    supp = sum(1 for f in findings if f.suppressed)
    warn = sum(1 for f in findings if f.severity == "warning")
    if errs:
        return False, (f"LINT GATE: FAIL — {len(errs)} error(s) "
                       f"({warn} warning(s), {supp} suppressed)")
    return True, (f"LINT GATE: ok — 0 errors ({warn} warning(s), "
                  f"{supp} suppressed)")


def format_report(findings: Sequence[Finding]) -> str:
    if not findings:
        return "lint: clean (no findings)"
    lines = []
    for f in sorted(findings, key=lambda f: (f.executable, f.pass_id)):
        tag = f"{f.severity}{' (suppressed)' if f.suppressed else ''}"
        lines.append(f"[{tag}] {f.executable} :: {f.pass_id}\n"
                     f"    at {f.location}\n    {f.message}")
    return "\n".join(lines)


def report_json(findings: Sequence[Finding], run: Optional[LintRun] = None) -> str:
    """The report as JSON; with ``run``, also every cell's verdict and
    what each executable's run recorded."""
    ok, verdict = gate(findings)
    doc: Dict[str, Any] = {"ok": ok, "verdict": verdict,
                           "findings": [f.as_dict() for f in findings]}
    if run is not None:
        doc.update(cells=run.table(), resources=run.resources)
    return json.dumps(doc, indent=2, default=str)


def cell_of(findings: Sequence[Finding]) -> str:
    """A cell's verdict: "ok" | "FAIL" | "supp" (every error suppressed)
    | "skip" (warnings only: smem-budget off a card)."""
    errs = [f for f in findings if f.severity == "error"]
    if errs:
        return "supp" if all(f.suppressed for f in errs) else "FAIL"
    return "skip" if any(f.severity == "warning" for f in findings) else "ok"


def lint_table(*, only: Optional[Sequence[str]] = None,
               device="cuda") -> Dict[str, Dict[str, str]]:
    """pass x executable matrix of the STATIC passes: cell is "ok" |
    "FAIL" | "supp" | "skip" | "-" (inapplicable). The ``--lint-table``
    payload."""
    pids = _pass_ids(None, static_only=True)
    run = lint_run(only=only, static_only=True, device=device).table()
    return {name: {p: run.get(name, {}).get(p, "-") for p in pids}
            for name in (tuple(only) if only else available_executables())}


def format_lint_table(table: Dict[str, Dict[str, str]]) -> str:
    if not table:
        return "(no executables)"
    pids = sorted({p for row in table.values() for p in row})
    w = max(len(n) for n in table) + 2
    hdr = "executable".ljust(w) + "".join(p.ljust(16) for p in pids)
    lines = [hdr, "-" * len(hdr)]
    for name in sorted(table):
        row = table[name]
        lines.append(name.ljust(w)
                     + "".join(row.get(p, "-").ljust(16) for p in pids))
    return "\n".join(lines)
