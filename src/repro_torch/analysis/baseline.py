"""Baseline-diff gate: known hazards are accepted debt, new ones fail (a
copy of the reference's ``repro/analysis/baseline.py``; the port's
committed baseline is ``analysis/torch_baseline.json``).

The baseline is a committed JSON file mapping each accepted finding's
formatting-stable key (see ``findings.Finding``) to a short record.  The
gate compares a fresh lint run against it:

* a finding whose key is **not** in the baseline is *new* → exit 1;
* a baseline entry with no matching finding is *stale* → warning only
  (the hazard was fixed; regen the baseline to shrink it).

Keys hash the offending statement's AST, so formatting-only edits keep
the baseline valid while any change to the hazardous statement itself
surfaces as a new finding for re-review.
"""
from __future__ import annotations

import json
from pathlib import Path

from .findings import Finding

__all__ = ["load_baseline", "write_baseline", "diff_baseline"]

_VERSION = 1


def load_baseline(path: Path) -> dict[str, dict]:
    data = json.loads(path.read_text())
    if data.get("version") != _VERSION:
        raise ValueError(
            f"baseline {path}: unsupported version {data.get('version')!r}")
    return dict(data.get("entries", {}))


def write_baseline(findings: list[Finding], path: Path) -> None:
    entries = {
        f.key: {"rule": f.rule, "axis": f.axis, "path": f.path,
                "scope": f.scope, "message": f.message}
        for f in findings if not f.suppressed
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(
        {"version": _VERSION,
         "entries": dict(sorted(entries.items()))},
        indent=2) + "\n")


def diff_baseline(
    findings: list[Finding], baseline: dict[str, dict]
) -> tuple[list[Finding], list[str]]:
    """Return ``(new_findings, stale_keys)``."""
    active = {f.key: f for f in findings if not f.suppressed}
    new = [f for k, f in active.items() if k not in baseline]
    stale = [k for k in baseline if k not in active]
    new.sort(key=lambda f: (f.path, f.line, f.rule))
    return new, sorted(stale)
