"""CLI: ``python -m repro_torch.analysis [--strict] [--select PASS …]``.

Exit codes, as the reference's CLI (``repro/analysis/__main__.py``): 0
clean (no findings, or all suppressed), 1 active findings, 2 an unknown
pass, or (``--strict`` only) stale baseline entries.  The baseline is
read, never written.  No pass needs a card or builds a kernel.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import (all_passes, apply_baseline, kernel_budget,
                                  load_baseline, run_all)
from repro_torch.analysis.project import repo_root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="launch-plan checks of the port's CUDA kernels")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries")
    ap.add_argument("--baseline", default=None,
                    help="suppression file (default: "
                         "<repo>/analysis-baseline.txt)")
    ap.add_argument("--select", action="append", default=None,
                    metavar="PASS",
                    help=f"run only these passes (repeatable); "
                         f"available: {', '.join(sorted(all_passes()))}")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--list-passes", action="store_true",
                    help="list pass names and exit")
    args = ap.parse_args(argv)

    if args.list_passes:
        for name in sorted(all_passes()):
            print(name)
        return 0
    if args.select:
        unknown = sorted(set(args.select) - set(all_passes()))
        if unknown:
            print(f"error: unknown pass(es): {', '.join(unknown)}",
                  file=sys.stderr)
            print(f"valid pass names: {', '.join(sorted(all_passes()))}",
                  file=sys.stderr)
            return 2

    patterns = load_baseline(args.baseline
                             or str(repo_root() / "analysis-baseline.txt"))
    active, suppressed, stale = apply_baseline(run_all(args.select),
                                               patterns)
    if args.as_json:
        print(json.dumps({"active": [vars(f) for f in active],
                          "suppressed": [vars(f) for f in suppressed],
                          "stale_baseline": stale,
                          "probes": [dict(label=label, entries=entries,
                                          launches=n) for label, entries, n
                                     in kernel_budget.last_report]},
                         indent=2))
    else:
        for label, entries, n in kernel_budget.last_report:
            print(f"-- {label}: {n} launch(es) through "
                  f"{', '.join(entries)}")
        for f in active:
            print(f.render())
        if suppressed:
            print(f"-- {len(suppressed)} finding(s) suppressed by baseline")
        for pat in stale:
            print(f"-- stale baseline entry (matches nothing): {pat}")
        n_passes = len(args.select or all_passes())
        print(f"{len(active)} finding(s) from {n_passes} pass(es)"
              + (" [strict]" if args.strict else ""))
    if active:
        return 1
    if args.strict and stale:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
