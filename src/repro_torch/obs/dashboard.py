"""Periodic text dashboard over the metrics hub.

A serving loop calls :meth:`Dashboard.step` once per served frame or
tick; every ``period`` observed
steps (or virtual seconds, when a clock is supplied) it renders a
fixed-width table of per-(stream, stage, rung, batch) latency summaries
plus the tracer's ring health, writing to any file-like sink.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional, TextIO

from .metrics import MetricsHub
from .span import SpanTracer

__all__ = ["render_table", "Dashboard"]


def render_table(hub: MetricsHub, tracer: Optional[SpanTracer] = None,
                 top: int = 12) -> str:
    """Fixed-width summary of the hottest metric keys (by count)."""
    rows = sorted(hub.table(), key=lambda r: (-r["count"], r["stream"],
                                              r["stage"]))
    header = (f"{'stream':<10}{'stage':<14}{'rung':<11}{'bs':>3}"
              f"{'n':>7}{'mean ms':>9}{'p50 ms':>9}{'p99 ms':>9}{'cv':>6}")
    lines = [header, "-" * len(header)]
    for r in rows[:top]:
        lines.append(
            f"{r['stream'][:9]:<10}{r['stage'][:13]:<14}{r['rung'][:10]:<11}"
            f"{r['batch_size']:>3}{r['count']:>7}"
            f"{r['mean'] * 1e3:>9.2f}{r['p50'] * 1e3:>9.2f}"
            f"{r['p99'] * 1e3:>9.2f}{r['cv']:>6.2f}")
    if len(rows) > top:
        lines.append(f"... {len(rows) - top} more keys")
    bad = sum(r.get("dropped", 0) for r in rows)
    if bad:
        lines.append(f"non-finite samples dropped: {bad}")
    if tracer is not None:
        lines.append(f"spans: {tracer.n_recorded} recorded, "
                     f"{tracer.dropped} dropped "
                     f"(ring capacity {tracer.capacity})")
    return "\n".join(lines)


class Dashboard:
    """Throttled renderer: call :meth:`step` once per served frame/tick."""

    def __init__(
        self,
        hub: MetricsHub,
        tracer: Optional[SpanTracer] = None,
        period: int = 50,
        sink: Optional[TextIO] = None,
        clock: Optional[Callable[[], float]] = None,
        min_interval_s: float = 0.0,
    ) -> None:
        if period < 1:
            raise ValueError(f"period must be >= 1 (got {period})")
        self.hub = hub
        self.tracer = tracer
        self.period = period
        self.sink = sink if sink is not None else sys.stderr
        self.clock = clock
        self.min_interval_s = min_interval_s
        self._steps = 0
        self._last_render_t = -float("inf")
        self.renders = 0

    def step(self) -> bool:
        """Register one step; render if the period elapsed. Returns
        whether a render happened (tests hook this)."""
        self._steps += 1
        if self._steps % self.period != 0:
            return False
        if self.clock is not None and self.min_interval_s > 0:
            now = self.clock()
            if now - self._last_render_t < self.min_interval_s:
                return False
            self._last_render_t = now
        self.render()
        return True

    def render(self) -> None:
        self.renders += 1
        banner = f"== obs dashboard · step {self._steps} =="
        print(banner, file=self.sink)
        print(render_table(self.hub, self.tracer), file=self.sink)
