"""Request queue for the multi-tenant serving runtime (copied from the
reference's ``repro/runtime/queue.py``: pure Python and NumPy).

A ``StreamRequest`` is one tenant's decode stream: a prompt, a token
budget, and (optionally) a per-token latency SLO.  The ``RequestQueue``
is the admission boundary between the load generator (Poisson arrivals
over the bus broker's simulated clock) and the ``MultiTenantEngine``'s
fixed-capacity slot table: arrivals wait here until the admission
controller either seats them in a free slot, defers them, or sheds them.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Optional

import numpy as np

__all__ = ["StreamRequest", "RequestQueue", "poisson_workload"]

# process-wide monotone admission-token source: every StreamRequest gets
# a unique integer at construction.  Unlike ``id(req)``, a token is never
# recycled when a request is garbage-collected, so the admission
# controller's deferred-request tracking cannot silently confuse a new
# request with a dead one.
_ADMISSION_TOKENS = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class StreamRequest:
    """One tenant's decode stream.

    ``deadline_s`` is the tenant's per-token SLO (None = best-effort: the
    tenant's adaptive deadline policy alone decides what counts as a miss,
    and admission control never sheds it).
    """

    tenant: str
    prompt: np.ndarray                 # (L,) int32, L >= 1
    max_new_tokens: int
    deadline_s: Optional[float] = None
    arrival_s: float = 0.0
    criticality: float = 1.0           # <1 tightens DynamicDeadline tenants
    # anytime service ladder: SLO relaxation factors tried (in order) before
    # the request is shed — degraded service beats no service
    degrade_factors: tuple[float, ...] = ()
    # identity of the *logical* request across defer/re-decide cycles.
    # ``dataclasses.replace`` copies it, so a degraded-SLO clone built by
    # AnytimeAdmission is still the same request to the controller's
    # per-request counters.  Excluded from comparisons: two requests with
    # identical payloads are still distinct admissions.
    admission_token: int = dataclasses.field(
        default_factory=lambda: next(_ADMISSION_TOKENS), compare=False)

    def __post_init__(self) -> None:
        p = np.asarray(self.prompt, np.int32)
        if p.ndim != 1 or p.shape[0] < 1:
            raise ValueError(
                f"stream {self.tenant!r}: prompt must be a 1-D array with at "
                f"least one token (got shape {np.asarray(self.prompt).shape})"
            )
        object.__setattr__(self, "prompt", p)
        if self.max_new_tokens < 1:
            raise ValueError(
                f"stream {self.tenant!r}: max_new_tokens must be >= 1"
            )
        if any(f < 1.0 for f in self.degrade_factors):
            raise ValueError(
                f"stream {self.tenant!r}: degrade_factors must relax the "
                f"SLO (>= 1), got {self.degrade_factors}"
            )


class RequestQueue:
    """FIFO admission queue with drop accounting.

    ``pop``/``requeue`` preserve arrival order for deferred requests; the
    engine pops the head, asks the admission controller, and either seats
    the stream or puts it back (defer) / drops it (shed).
    """

    def __init__(self) -> None:
        self._q: deque[StreamRequest] = deque()
        self.pushed = 0

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def push(self, req: StreamRequest) -> None:
        self._q.append(req)
        self.pushed += 1

    def pop(self) -> StreamRequest:
        return self._q.popleft()

    def peek(self) -> Optional[StreamRequest]:
        return self._q[0] if self._q else None

    def requeue(self, req: StreamRequest) -> None:
        """Put a deferred request back at the head (keeps FIFO order)."""
        self._q.appendleft(req)


def poisson_workload(
    n_streams: int,
    rate_hz: float,
    vocab_size: int,
    prompt_len: int = 8,
    max_new_tokens: int = 32,
    deadline_s: Optional[float] = None,
    seed: int = 0,
    degrade_factors: tuple[float, ...] = (),
) -> list[StreamRequest]:
    """``n_streams`` requests with exponential inter-arrival times (a
    Poisson arrival process at ``rate_hz``), random prompts, one tenant id
    per stream.  Deterministic given the seed."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, n_streams)
    arrivals = np.cumsum(gaps)
    reqs = []
    for i in range(n_streams):
        reqs.append(
            StreamRequest(
                tenant=f"tenant-{i:02d}",
                prompt=rng.integers(0, vocab_size, prompt_len).astype(np.int32),
                max_new_tokens=max_new_tokens,
                deadline_s=deadline_s,
                arrival_s=float(arrivals[i]),
                degrade_factors=degrade_factors,
            )
        )
    return reqs
