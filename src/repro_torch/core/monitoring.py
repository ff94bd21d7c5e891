"""Process-wide duration events for program builds: the port's counterpart
of the two ``jax.monitoring`` calls the reference's sentinel relies on.

JAX fires ``/jax/core/compile/backend_compile_duration`` once per real
backend compile and ``/jax/core/compile/jaxpr_trace_duration`` once per
trace of a Python function.  The port has no compiler in the loop; its
program builds are the batched executor's step builds (one CUDA graph
capture per shard on the card, one eager run per shard on the CPU) and the
multi-tenant engine's step warm-up.  Each build site reports here with
``record_event_duration_secs``, and ``analysis.sentinel`` listens with
``register_event_duration_secs_listener``.  Dependency-free, so any layer
can fire events without importing the analysis package.
"""
from __future__ import annotations

import threading
from typing import Callable

__all__ = ["BUILD_EVENT", "TRACE_EVENT", "record_event_duration_secs",
           "register_event_duration_secs_listener"]

# one program built (a CUDA graph captured, or a step's CPU build)
BUILD_EVENT = "/repro_torch/program/build_duration"
# one run of a step's Python body made while building a program
TRACE_EVENT = "/repro_torch/program/trace_duration"

_lock = threading.Lock()
_listeners: list[Callable[..., None]] = []


def register_event_duration_secs_listener(listener: Callable[..., None]) -> None:
    """Call ``listener(event, duration_secs, **kwargs)`` on every recorded
    event from now on.  There is no unregister, as in ``jax.monitoring``."""
    with _lock:
        _listeners.append(listener)


def record_event_duration_secs(event: str, duration: float, **kwargs) -> None:
    """Report one event of ``duration`` seconds to every listener."""
    with _lock:
        listeners = list(_listeners)
    for listener in listeners:
        listener(event, float(duration), **kwargs)
