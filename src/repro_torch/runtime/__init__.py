"""Serving runtime package (the port of the reference's ``repro.runtime``).

* ``engine``       — single-stream instrumented batched decode.
* ``queue``        — ``StreamRequest`` / ``RequestQueue`` admission boundary
                     and the Poisson workload generator.
* ``admission``    — deadline-aware admission control over a learned
                     occupancy → step-latency model.
* ``multi_tenant`` — fixed-capacity continuous-batching engine: streams
                     join/leave padded slots without a new build of the
                     step, with per-tenant deadline policies and variance
                     attribution.
"""
from .admission import AdmissionController, AdmissionDecision, AlwaysAdmit, AnytimeAdmission
from .engine import Engine, ServeConfig, make_prefill_step, make_serve_step
from .multi_tenant import MultiTenantConfig, MultiTenantEngine, TenantState
from .queue import RequestQueue, StreamRequest, poisson_workload

__all__ = [
    "Engine",
    "ServeConfig",
    "make_prefill_step",
    "make_serve_step",
    "AdmissionController",
    "AdmissionDecision",
    "AlwaysAdmit",
    "AnytimeAdmission",
    "MultiTenantConfig",
    "MultiTenantEngine",
    "TenantState",
    "RequestQueue",
    "StreamRequest",
    "poisson_workload",
]
