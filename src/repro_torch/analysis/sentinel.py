"""Runtime trace sentinel: count *actual* program builds and guard host
synchronisation over a region of execution (the port of the reference's
``repro/analysis/sentinel.py``).

Static lint catches hazards it can see in source; the sentinel catches
the ones it can't (a shape that drifts across modules and forces a new
capture, a stray host read in a tick).  It replaces ad-hoc
``step_captures == 1`` assertions and hand-written
``torch.cuda.set_sync_debug_mode`` guards with one shared facility::

    with TraceSentinel(compile_budget=0) as sent:
        for _ in range(ticks):
            engine.tick(frames)
    sent.report()          # -> SentinelReport
    sent.check()           # raises TimingHazardError over budget

What counts:

* ``compiles`` — program builds, the port's counterpart of JAX's backend
  compiles: each CUDA graph capture of a batched step (one per shard), on
  the CPU each shard's step build, and the multi-tenant engine's step
  warm-up.  Every build site fires ``core.monitoring.BUILD_EVENT`` with
  its duration; one module-level listener accumulates global counters, and
  each sentinel snapshots them on entry and diffs them on exit.  A
  sentinel around a fresh executor's warm-up therefore reads the same
  number as the rise in its ``step_captures``.
* ``traces`` — runs of a step's Python body made while building it
  (``core.monitoring.TRACE_EVENT``): the eager warm-up runs that precede a
  capture and the run under the capture on the card, the one eager run on
  the CPU.  The counterpart of JAX's jaxpr traces: cheaper than a build,
  and bounded only when ``trace_budget`` is set.

Host synchronisation is guarded with ``torch.cuda.set_sync_debug_mode``:
under ``"disallow"`` any synchronising CUDA call inside the region (an
``.item()``, a pageable host-to-device copy, a ``torch.cuda.synchronize``)
raises at the offending call site.  Waits on a ``torch.cuda.Event`` stay
allowed, so the executor's one event wait per drained tick passes.
"""
from __future__ import annotations

import dataclasses
import threading

import torch

from ..core.monitoring import BUILD_EVENT, TRACE_EVENT, register_event_duration_secs_listener

__all__ = ["TraceSentinel", "SentinelReport", "TimingHazardError"]

# the reference's transfer_guard levels -> torch.cuda.set_sync_debug_mode modes
SYNC_DEBUG_MODES = {"allow": "default", "log": "warn", "disallow": "error"}
_ERROR_MODE = 2          # torch.cuda.get_sync_debug_mode() of "error"

_lock = threading.Lock()
_counters = {"compiles": 0, "traces": 0}
_installed = False
_active: list["TraceSentinel"] = []   # sentinels currently entered


def _listener(event: str, duration: float, **kwargs) -> None:
    if event == BUILD_EVENT:
        with _lock:
            _counters["compiles"] += 1
            watchers = [s for s in _active if s.tracer is not None]
        # outside the lock: a tracer's own lock must never nest inside ours
        for s in watchers:
            s._emit_compile(duration)
    elif event == TRACE_EVENT:
        with _lock:
            _counters["traces"] += 1


def _install() -> None:
    global _installed
    with _lock:
        if _installed:
            return
        _installed = True
    register_event_duration_secs_listener(_listener)


class TimingHazardError(AssertionError):
    """A sentinel budget was exceeded.  Subclasses AssertionError so the
    legacy ``assert step_captures == 1`` call sites upgrade transparently."""


@dataclasses.dataclass(frozen=True)
class SentinelReport:
    compiles: int
    traces: int
    compile_budget: int
    trace_budget: int | None
    transfer_guard: str

    @property
    def ok(self) -> bool:
        if self.compiles > self.compile_budget:
            return False
        if self.trace_budget is not None and self.traces > self.trace_budget:
            return False
        return True

    def to_dict(self) -> dict:
        return dataclasses.asdict(self) | {"ok": self.ok}

    def render(self) -> str:
        status = "ok" if self.ok else "OVER BUDGET"
        tb = "-" if self.trace_budget is None else self.trace_budget
        return (f"TraceSentinel[{status}] compiles={self.compiles}/"
                f"{self.compile_budget} traces={self.traces}/{tb} "
                f"transfer_guard={self.transfer_guard}")


class TraceSentinel:
    """Context manager bounding program builds and host synchronisation in
    a region.

    Parameters
    ----------
    compile_budget:
        Maximum *program builds* (module docstring) allowed inside the
        region.  The steady state after warm-up is 0: enter the sentinel
        only after ``engine.compile()`` / ``scheduler.warm()``.
    trace_budget:
        Optional cap on step runs made while building (module docstring);
        unbounded by default.
    transfer_guard:
        ``"disallow"`` (default), ``"log"`` or ``"allow"``: the
        ``torch.cuda.set_sync_debug_mode`` mode of the region (``"error"``,
        ``"warn"``, ``"default"``).  On entry the device is synchronised
        (unless an enclosing region already forbids syncs, in which case
        nothing is pending that it did not see) and the mode is set; on exit
        the mode that was set before is restored, so sentinels nest.  Where
        torch has no CUDA device there is no device↔host transfer to guard
        and the mode is not touched; where CUDA is available the guard is
        always armed, and a failure to arm it raises.
    strict:
        When true (default), ``__exit__`` raises :class:`TimingHazardError`
        if a budget was exceeded.  When false, call :meth:`check` or
        inspect :meth:`report` manually.
    tracer:
        Optional ``repro_torch.obs.SpanTracer`` (duck-typed — analysis
        stays obs-free).  While the sentinel is entered, every program
        build is also recorded on the tracer as a ``backend_compile`` span
        on the paper's *runtime* axis, so build excursions land in the same
        timeline as the serving spans they delayed.
    """

    def __init__(
        self,
        compile_budget: int = 0,
        trace_budget: int | None = None,
        transfer_guard: str = "disallow",
        strict: bool = True,
        tracer=None,
    ) -> None:
        if transfer_guard not in SYNC_DEBUG_MODES:
            raise ValueError(f"transfer_guard must be one of {sorted(SYNC_DEBUG_MODES)}, "
                             f"not {transfer_guard!r}")
        self.compile_budget = int(compile_budget)
        self.trace_budget = (None if trace_budget is None
                             else int(trace_budget))
        self.transfer_guard = transfer_guard
        self.strict = strict
        self.tracer = tracer
        self._start: dict[str, int] | None = None
        self._end: dict[str, int] | None = None
        self._prev_mode: int | None = None

    def _emit_compile(self, duration: float) -> None:
        t1 = self.tracer.clock()
        self.tracer.record("backend_compile", t1 - float(duration), t1,
                           axis="runtime")

    # ------------------------------------------------------------------
    def __enter__(self) -> "TraceSentinel":
        _install()
        if torch.cuda.is_available():
            prev = torch.cuda.get_sync_debug_mode()
            if prev != _ERROR_MODE:
                torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode(SYNC_DEBUG_MODES[self.transfer_guard])
            self._prev_mode = prev
        with _lock:
            self._start = dict(_counters)
            _active.append(self)
        self._end = None
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._prev_mode is not None:
            torch.cuda.set_sync_debug_mode(self._prev_mode)
            self._prev_mode = None
        with _lock:
            self._end = dict(_counters)
            if self in _active:
                _active.remove(self)
        if exc_type is None and self.strict:
            self.check()
        return False

    # ------------------------------------------------------------------
    def _delta(self) -> tuple[int, int]:
        if self._start is None:
            return 0, 0
        end = self._end
        if end is None:
            with _lock:
                end = dict(_counters)
        return (end["compiles"] - self._start["compiles"],
                end["traces"] - self._start["traces"])

    def report(self) -> SentinelReport:
        compiles, traces = self._delta()
        return SentinelReport(
            compiles=compiles, traces=traces,
            compile_budget=self.compile_budget,
            trace_budget=self.trace_budget,
            transfer_guard=self.transfer_guard)

    def check(self) -> SentinelReport:
        rep = self.report()
        if not rep.ok:
            raise TimingHazardError(
                f"{rep.render()} — unexpected program build inside a "
                "sentinel-guarded region (TV002: capture hazard). Warm up "
                "before entering the sentinel, or raise the budget if the "
                "region legitimately builds.")
        return rep
