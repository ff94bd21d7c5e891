"""Timing-hazard analysis of the port: the static timing certifier
(``cert``, tvcert).  ``python -m repro_torch.analysis.cert --check``
recounts the shipped tree and compares it with the committed
``analysis/torch_certificate.json``.
"""
from .cert import (CPU_2CORE, DEFAULT_CERT_PATH, DRIFT_TOL, H100_SXM, Counts, Hardware,
                   InputEnvelope, build_static, check, count_program, default_envelope,
                   drift_findings, envelope_hash, roofline_floor)

__all__ = ["CPU_2CORE", "DEFAULT_CERT_PATH", "DRIFT_TOL", "H100_SXM", "Counts", "Hardware",
           "InputEnvelope", "build_static", "check", "count_program", "default_envelope",
           "drift_findings", "envelope_hash", "roofline_floor"]
