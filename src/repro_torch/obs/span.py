"""Low-overhead span tracer (the port of ``repro/obs/span.py``) — the single recording path for every
timing observation in the serving stack.

The paper attributes DNN inference-time variation to six axes (data,
I/O, model, runtime, hardware, end-to-end); a :class:`Span` is one timed
interval *tagged* with the axis it belongs to plus the serving context
needed to attribute it later: stream/tenant id, tick, rung, batch size,
and a pipeline ``track`` so overlapped pipelined ticks render on
parallel rows in Perfetto.

Design constraints, in order:

* **Low overhead** — recording a span is one clock read, a dataclass
  construction, and a ring-buffer slot write under a lock.  The ring is
  preallocated (a fixed-length list), so the steady state allocates no
  container storage and never triggers list growth.
* **Bounded memory** — the ring keeps the most recent ``capacity``
  spans; older spans are overwritten and counted in ``dropped`` (the CI
  smoke asserts zero drops at the default capacity).
* **Deterministic under virtual time** — the clock is injected.  Under
  a ``SimClock`` every timestamp is virtual, so scenario-replay traces
  are byte-reproducible and tracing can never perturb a replay
  decision (the tracer only ever *reads* the clock).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Iterator, Optional

from ..core.timing import fence as _fence

__all__ = ["AXES", "Span", "SpanTracer", "DEFAULT_CAPACITY"]

# the paper's six perspectives on inference-time variation (the
# reference's ``analysis/findings.py:23``)
AXES = ("data", "io", "model", "runtime", "hardware", "end_to_end")

DEFAULT_CAPACITY = 65536


@dataclasses.dataclass(frozen=True)
class Span:
    """One timed interval with variance-attribution tags.

    ``seq`` is assigned at *open* time (so a parent's id is known to its
    children even though parents close last); the ring holds spans in
    *close* order.  ``parent`` is the ``seq`` of the enclosing open span
    or ``-1`` at top level.  ``track`` separates overlapped pipelined
    ticks onto parallel renderer rows (tid in the Chrome trace).
    ``shard`` is the data-shard id serving the interval on a fleet mesh
    (``-1`` = not shard-specific / single-device).
    """

    name: str
    t0: float
    t1: float
    stream: str = ""
    tick: int = 0
    rung: str = ""
    batch_size: int = 0
    axis: str = "end_to_end"
    track: int = 0
    parent: int = -1
    seq: int = 0
    shard: int = -1

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class SpanTracer:
    """Preallocated ring buffer of :class:`Span` records.

    Usage::

        tracer = SpanTracer(clock=clock)       # SimClock-compatible
        with tracer.span("inference", axis="model", rung="two_stage",
                         fence=lambda: out):   # waited for at exit
            out = step(x)
        tracer.instant("rung_switch", axis="model", stream="cam0")

    ``fence`` values (a tensor tree, or a zero-arg callable returning
    one, evaluated at exit) are passed to ``core.timing.fence`` before
    the interval closes, so a span around asynchronous CUDA work
    measures its execution, not its launch.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 (got {capacity})")
        self.capacity = capacity
        self.clock = clock
        self._ring: list[Optional[Span]] = [None] * capacity
        self._n = 0                    # spans ever recorded (close order)
        self._next_seq = 0             # ids handed out (open order)
        self._open: list[int] = []     # seq stack of open spans
        self._lock = threading.Lock()

    # ---------------- recording ----------------
    def record(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        stream: str = "",
        tick: int = 0,
        rung: str = "",
        batch_size: int = 0,
        axis: str = "end_to_end",
        track: int = 0,
        parent: Optional[int] = None,
        shard: int = -1,
    ) -> Span:
        """Write one already-measured interval into the ring (the adapter
        entry point used by ``StageTimer`` and the engines' per-tick
        emission).  Returns the recorded span."""
        if axis not in AXES:
            raise ValueError(f"unknown axis {axis!r}; axes: {AXES}")
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            if parent is None:
                parent = self._open[-1] if self._open else -1
            span = Span(name=name, t0=t0, t1=t1, stream=stream, tick=tick,
                        rung=rung, batch_size=batch_size, axis=axis,
                        track=track, parent=parent, seq=seq, shard=shard)
            self._ring[self._n % self.capacity] = span
            self._n += 1
        return span

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        *,
        stream: str = "",
        tick: int = 0,
        rung: str = "",
        batch_size: int = 0,
        axis: str = "end_to_end",
        track: int = 0,
        shard: int = -1,
        fence: Any = None,
    ) -> Iterator[None]:
        """Context-managed span with nesting (children see this span as
        their ``parent``).  ``fence`` — a tensor tree or a zero-arg
        callable returning one (evaluated at exit, so it can name a
        value assigned inside the block) — is blocked on before the
        interval closes so async dispatch cannot leak out of the
        measurement."""
        if axis not in AXES:
            raise ValueError(f"unknown axis {axis!r}; axes: {AXES}")
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            parent = self._open[-1] if self._open else -1
            self._open.append(seq)
        t0 = self.clock()
        try:
            yield
        finally:
            if fence is not None:
                _fence(fence() if callable(fence) else fence)
            t1 = self.clock()
            with self._lock:
                if self._open and self._open[-1] == seq:
                    self._open.pop()
                else:                  # out-of-order close (generator abuse)
                    try:
                        self._open.remove(seq)
                    except ValueError:
                        pass
                span = Span(name=name, t0=t0, t1=t1, stream=stream,
                            tick=tick, rung=rung, batch_size=batch_size,
                            axis=axis, track=track, parent=parent, seq=seq,
                            shard=shard)
                self._ring[self._n % self.capacity] = span
                self._n += 1

    def instant(self, name: str, **tags) -> Span:
        """Zero-duration event (rung switch, admission decision, backend
        compile) on the shared timeline."""
        now = self.clock()
        return self.record(name, now, now, **tags)

    # ---------------- reading ----------------
    @property
    def n_recorded(self) -> int:
        """Total spans ever recorded (including overwritten ones)."""
        return self._n

    @property
    def dropped(self) -> int:
        """Spans lost to ring wrap-around."""
        return max(0, self._n - self.capacity)

    def spans(self) -> list[Span]:
        """Retained spans, oldest first (close order)."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                out = self._ring[:n]
            else:
                k = n % cap
                out = self._ring[k:] + self._ring[:k]
        return [s for s in out if s is not None]

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._n = 0
            self._open.clear()
