"""Simulated clock shared by the broker and the serving runtime.

The load generator publishes requests onto the broker stamped with their
Poisson arrival times; the serving loop advances this clock by each
*measured* engine step latency and flushes broker deliveries due by the
new time.  Simulated transport and real compute therefore interleave on
one timeline — the same discipline the end-to-end system benchmark uses
to attribute variance to I/O.
"""
from __future__ import annotations

__all__ = ["SimClock"]


class SimClock:
    """Monotonic simulated clock (seconds)."""

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)

    def time(self) -> float:
        return self._now

    def __call__(self) -> float:
        """Clock-callable alias, so a SimClock drops into any
        ``clock: Callable[[], float]`` slot (e.g. ``StageTimer(clock=...)``)
        in place of ``time.perf_counter``."""
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance the clock by {dt} s")
        self._now += float(dt)
        return self._now

    def advance_to(self, t: float) -> float:
        """Fast-forward to an absolute time (no-op if already past it) —
        used when the engine idles waiting for the next Poisson arrival."""
        self._now = max(self._now, float(t))
        return self._now
