"""tvcert — the static timing certifier, on torch programs.

The port of ``repro.analysis.cert``: instead of watching a live engine or
pattern-matching source, it counts every registered hot-path program on
fake tensors over the declared input envelope and certifies, before any
frame runs:

* **capture-freedom** — every envelope point (rung × batch-size ×
  occupancy, plus join/leave churn, at every declared shard count) maps
  to an already-seen signature, so each shard's step is captured once;
* **cost honesty** — static FLOP/byte counts yield a roofline floor per
  (rung, batch-size) on the H100, cross-checked against the calibrated
  cost-model priors (drift gate) and the card's measured step times
  (floor ≤ measurement, always);
* **host hygiene** — no host-interaction op (``.item()``, a data-dependent
  shape, a copy across devices) hides inside a program, and the inputs a
  program declares it writes in place are the ones it writes.

The committed ``analysis/torch_certificate.json`` pins all of it; the
``python -m repro_torch.analysis.cert --check`` gate recounts the static
parts on the CPU and fails on drift.  See ``envelope`` (the input
universe), ``tracer`` (recorder-instrumented engine sweeps), ``costs``
(op counting), ``roofline`` (floors + drift gate), ``certificate``
(assembly/serialization/check).
"""
from .certificate import (DEFAULT_CERT_PATH, DRIFT_TOL, attach_measured, build_static, check,
                          intrinsic_findings, load_certificate, measure_steps, render_report,
                          write_certificate)
from .costs import Counts, count_program, program_io_bytes
from .envelope import DTYPES, InputEnvelope, KernelPoint, RungPoint, default_envelope, \
    envelope_hash
from .roofline import CPU_2CORE, H100_SXM, Hardware, drift_findings, roofline_floor
from .tracer import (ProgramRecorder, ProgramSummary, RungTrace, aval_signature, certify_rung,
                     trace_kernel, trace_ladder_rung)

__all__ = [
    "DEFAULT_CERT_PATH", "DRIFT_TOL", "attach_measured", "build_static", "check",
    "intrinsic_findings", "load_certificate", "measure_steps", "render_report",
    "write_certificate",
    "Counts", "count_program", "program_io_bytes",
    "DTYPES", "InputEnvelope", "KernelPoint", "RungPoint", "default_envelope",
    "envelope_hash",
    "CPU_2CORE", "H100_SXM", "Hardware", "drift_findings", "roofline_floor",
    "ProgramRecorder", "ProgramSummary", "RungTrace", "aval_signature", "certify_rung",
    "trace_kernel", "trace_ladder_rung",
]
