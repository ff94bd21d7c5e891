"""File walking, suppression comments, and report assembly for the
port's tvlint (a copy of the reference's ``repro/analysis/lint.py``: the
module is framework-free, and the port imports nothing of the reference).

Suppression: a hazard that is *intentional* (e.g. the executor's
dispatch-latency probe deliberately measures unfenced submit time) is
silenced at the source with::

    x = compute()  # tvlint: disable=TV006 (dispatch latency is the point)

or with a standalone comment on the line directly above the finding.
Suppressed findings are still reported (``suppressed: true``) so the
inventory of intentional hazards stays visible, but they never fail the
baseline gate.
"""
from __future__ import annotations

import io
import json
import re
import tokenize
from pathlib import Path

from .findings import Finding
from .rules import analyze_module

__all__ = ["lint_source", "lint_file", "lint_paths", "report_dict"]

_SUPPRESS_RE = re.compile(r"tvlint:\s*disable=([A-Z0-9,\s]+)")


def _suppressions(source: str) -> dict[int, set[str]]:
    """Map line number -> set of rule codes disabled on that line.

    A ``# tvlint: disable=...`` comment covers its own line; a comment
    that is the only thing on its line covers the next line that holds
    code (falling through blank lines and continuation comment lines, so
    multi-line explanations work).
    """
    out: dict[int, set[str]] = {}
    lines = source.splitlines()

    def _next_code_line(after: int) -> int:
        for i in range(after, len(lines) + 1):
            text = lines[i - 1].strip() if i <= len(lines) else ""
            if text and not text.startswith("#"):
                return i
        return after

    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
            line = tok.start[0]
            out.setdefault(line, set()).update(codes)
            stripped = tok.line.strip()
            if stripped.startswith("#"):          # standalone comment line
                target = _next_code_line(line + 1)
                out.setdefault(target, set()).update(codes)
    except tokenize.TokenError:
        pass
    return out


def lint_source(source: str, path: str) -> list[Finding]:
    """Lint one module given its source text and root-relative path."""
    findings = analyze_module(source, path)
    sup = _suppressions(source)
    out: list[Finding] = []
    for f in findings:
        codes = sup.get(f.line, set())
        if f.rule in codes or "ALL" in codes:
            f = Finding(**{**f.to_dict(), "suppressed": True})
        out.append(f)
    return out


def lint_file(file: Path, root: Path) -> list[Finding]:
    rel = file.resolve().relative_to(root.resolve()).as_posix()
    return lint_source(file.read_text(), rel)


def lint_paths(paths: list[Path], root: Path) -> list[Finding]:
    """Lint every ``.py`` file under the given paths (sorted walk, so
    output order is deterministic)."""
    files: list[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    findings: list[Finding] = []
    for f in files:
        findings.extend(lint_file(f, root))
    return findings


def report_dict(findings: list[Finding]) -> dict:
    active = [f for f in findings if not f.suppressed]
    by_rule: dict[str, int] = {}
    for f in active:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        "version": 1,
        "total": len(findings),
        "active": len(active),
        "suppressed": len(findings) - len(active),
        "by_rule": dict(sorted(by_rule.items())),
        "findings": [f.to_dict() for f in findings],
    }


def write_report(findings: list[Finding], dest: Path) -> None:
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(report_dict(findings), indent=2,
                               sort_keys=False) + "\n")
