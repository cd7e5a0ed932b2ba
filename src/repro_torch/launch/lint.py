"""CLI of the lint gate (port of ``repro/launch/lint.py``).

    python -m repro_torch.launch.lint                     # full report, on the card
    python -m repro_torch.launch.lint --device cpu        # on the CPU
    python -m repro_torch.launch.lint --gate              # CI: exit 1 on errors
    python -m repro_torch.launch.lint --json-out r.json   # machine-readable: findings,
                                                          # every cell, kernel resources
    python -m repro_torch.launch.lint --table             # pass x executable grid
    python -m repro_torch.launch.lint --only moe_layer/dense --passes no-collectives

The executables run on ``--device`` (default ``cuda``); without a card
that exits 2, it never falls back to the CPU. The multi-rank executables
run in one gloo group of 8 processes of this module (``--rank``, hidden),
started by the run and joined before the report.
"""
import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.lint",
        description="lint gate over every registered executable")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 if any unsuppressed error survives")
    ap.add_argument("--json-out", metavar="PATH",
                    help="write the full report as JSON")
    ap.add_argument("--table", action="store_true",
                    help="print the static pass x executable matrix")
    ap.add_argument("--only", action="append", default=None,
                    metavar="EXECUTABLE",
                    help="restrict to named executable(s)")
    ap.add_argument("--passes", action="append", default=None,
                    metavar="PASS", help="restrict to pass id(s)")
    ap.add_argument("--static-only", action="store_true",
                    help="skip the scenario pass (host-sync)")
    ap.add_argument("--list", action="store_true",
                    help="list executables and passes, run nothing")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the executables run (default: the card)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--work-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from repro_torch.analysis.executables import available_executables
    from repro_torch.analysis.lint import (check_device, format_lint_table,
                                           format_report, gate, lint_run,
                                           lint_table, rank_main, report_json)
    from repro_torch.analysis.passes import available_passes, get_pass

    if args.rank is not None:                  # one rank of a lint group
        return rank_main(args.rank, args.work_dir)

    if args.list:
        print("passes:")
        for p in available_passes():
            print(f"  {p:<16} {get_pass(p).doc.splitlines()[0]}")
        print("executables:")
        for n in available_executables():
            print(f"  {n}")
        return 0

    try:
        check_device(args.device)
    except RuntimeError as e:
        print(f"lint: {e} (pass --device cpu to lint on the CPU)", file=sys.stderr)
        return 2

    if args.table:
        print(format_lint_table(lint_table(only=args.only, device=args.device)))
        return 0

    run = lint_run(only=args.only, passes=args.passes,
                   static_only=args.static_only, device=args.device)
    findings = run.findings
    print(format_report(findings))
    ok, verdict = gate(findings)
    print(verdict)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            f.write(report_json(findings, run))
        print(f"wrote {args.json_out}")
    return 0 if (ok or not args.gate) else 1


if __name__ == "__main__":
    sys.exit(main())
