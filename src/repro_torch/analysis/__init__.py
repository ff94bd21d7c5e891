"""Timing-hazard analysis of the port: the static lint (tvlint), the
runtime trace sentinel, and the static timing certifier (``cert``,
tvcert).

``python -m repro_torch.analysis src/repro_torch --baseline
analysis/torch_baseline.json`` runs the static pass and fails on any hazard
not in the committed baseline; :class:`TraceSentinel` bounds actual
program builds (CUDA graph captures) and host synchronisation at run time;
``python -m repro_torch.analysis.cert --check`` recounts the shipped tree
and compares it with the committed ``analysis/torch_certificate.json``.
"""
from .baseline import diff_baseline, load_baseline, write_baseline
from .cert import (CPU_2CORE, DEFAULT_CERT_PATH, DRIFT_TOL, H100_SXM, Counts, Hardware,
                   InputEnvelope, build_static, check, count_program, default_envelope,
                   drift_findings, envelope_hash, roofline_floor)
from .findings import AXES, RULES, Finding, Rule
from .lint import lint_file, lint_paths, lint_source, report_dict
from .sentinel import SentinelReport, TimingHazardError, TraceSentinel

__all__ = [
    "AXES", "RULES", "Rule", "Finding",
    "lint_source", "lint_file", "lint_paths", "report_dict",
    "load_baseline", "write_baseline", "diff_baseline",
    "TraceSentinel", "SentinelReport", "TimingHazardError",
    "CPU_2CORE", "DEFAULT_CERT_PATH", "DRIFT_TOL", "H100_SXM", "Counts", "Hardware",
    "InputEnvelope", "build_static", "check", "count_program", "default_envelope",
    "drift_findings", "envelope_hash", "roofline_floor",
]
