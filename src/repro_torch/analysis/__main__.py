"""CLI for the port's timing-hazard lint (the torch rules of ``rules``).

Exit codes: 0 clean (or all findings baselined/suppressed), 1 new
hazards found, 2 usage/internal error.

Examples::

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch \
        --baseline analysis/torch_baseline.json
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch \
        --baseline analysis/torch_baseline.json --regen-baseline
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch --report findings.json

The static timing certifier is its own entry point:
``python -m repro_torch.analysis.cert``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .baseline import diff_baseline, load_baseline, write_baseline
from .lint import lint_paths, write_report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="tvlint: static timing-hazard analysis (TV001-TV008)")
    ap.add_argument("paths", nargs="+", type=Path,
                    help="files or directories to lint")
    ap.add_argument("--root", type=Path, default=None,
                    help="root for relative paths in finding keys "
                         "(default: the parent of a first path named repro_torch, "
                         "else cwd)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline JSON; fail only on findings not in it")
    ap.add_argument("--regen-baseline", action="store_true",
                    help="rewrite --baseline from this run's findings")
    ap.add_argument("--report", type=Path, default=None,
                    help="write the full findings report JSON here")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-finding output, print summary only")
    args = ap.parse_args(argv)

    for p in args.paths:
        if not p.exists():
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    root = args.root
    if root is None:
        first = args.paths[0].resolve()
        root = first.parent if first.name == "repro_torch" else Path.cwd()
    try:
        findings = lint_paths(args.paths, root)
    except SyntaxError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.report is not None:
        write_report(findings, args.report)

    active = [f for f in findings if not f.suppressed]

    if args.regen_baseline:
        if args.baseline is None:
            print("error: --regen-baseline requires --baseline",
                  file=sys.stderr)
            return 2
        write_baseline(findings, args.baseline)
        print(f"baseline regenerated: {args.baseline} "
              f"({len(active)} entries)")
        return 0

    if args.baseline is not None:
        try:
            baseline = load_baseline(args.baseline)
        except FileNotFoundError:
            print(f"error: baseline not found: {args.baseline} "
                  "(run with --regen-baseline to create it)",
                  file=sys.stderr)
            return 2
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        new, stale = diff_baseline(findings, baseline)
        if not args.quiet:
            for f in new:
                print(f.render())
        for k in stale:
            print(f"note: stale baseline entry (hazard fixed?): {k}")
        print(f"tvlint: {len(active)} active finding(s), "
              f"{len(new)} new vs baseline, {len(stale)} stale entr(ies)")
        return 1 if new else 0

    if not args.quiet:
        for f in findings:
            print(f.render())
    by_rule: dict[str, int] = {}
    for f in active:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    summary = ", ".join(f"{k}={v}" for k, v in sorted(by_rule.items()))
    print(f"tvlint: {len(active)} active finding(s)"
          + (f" ({summary})" if summary else ""))
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
