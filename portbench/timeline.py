"""The traced stretch, reduced from ``torch.profiler``'s timeline to what the
metric readers (``metrics/<name>.py``) take: the device's operations (name,
start, end, in ns on the host's clock, as the profiler aligns them), the
harness's own spans (one per request or step, with its shape), and the
host's operations for the idle gaps.

The device is busy where any kernel, copy or fill runs: the union of their
intervals on the one timeline, so two overlapping operations count once.
The stretch's wall time is its spans' extent.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Iterable, Optional

SPAN_PREFIX = "portbench."


@dataclasses.dataclass(frozen=True)
class Span:
    """One request or step of the traced stretch."""
    kind: str
    start: int
    end: int
    shape: dict


@dataclasses.dataclass
class Trace:
    ops: list            # (start, end, name) of every device operation, by start
    host: list           # (start, end, name) of the host's operations, by start
    spans: list          # Span, by start

    @property
    def start(self) -> int:
        return self.spans[0].start

    @property
    def end(self) -> int:
        return self.spans[-1].end

    @property
    def wall_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def ops_in(self, span: Span) -> list:
        """The device operations that start inside ``span``."""
        lo = bisect.bisect_left(self.ops, (span.start,))
        hi = bisect.bisect_left(self.ops, (span.end,))
        return self.ops[lo:hi]

    def busy_s(self) -> float:
        """Seconds of the stretch in which some operation ran on the device."""
        return union_ns(clip(self.ops, self.start, self.end)) * 1e-9

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.wall_s

    def gaps(self, min_ns: int = 1000) -> list:
        """(start, end) of each idle stretch of the device of at least
        ``min_ns`` inside the traced wall."""
        out, t = [], self.start
        for a, b, _ in clip(self.ops, self.start, self.end):
            if a - t >= min_ns:
                out.append((t, a))
            t = max(t, b)
        if self.end - t >= min_ns:
            out.append((t, self.end))
        return out

    def host_at(self, t: int) -> str:
        """The innermost host operation running at ``t``, or ``"none"``."""
        i = bisect.bisect_right(self.host, (t, float("inf")))
        best: Optional[tuple] = None
        for a, b, name in reversed(self.host[max(0, i - 400):i]):
            if a <= t < b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "none"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        time by what the host was doing when the device went idle."""
        by_op: dict[str, float] = {}
        for a, b, name in clip(self.ops, self.start, self.end):
            by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-9
        by_host: dict[str, float] = {}
        for a, b in self.gaps():
            name = self.host_at(a)
            by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-9
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def clip(ops: Iterable, lo: int, hi: int) -> list:
    return [(max(a, lo), min(b, hi), n) for a, b, n in ops if b > lo and a < hi]


def union_ns(ops: Iterable) -> int:
    busy, end = 0, None
    for a, b, _ in sorted(ops):
        if end is None or a >= end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def from_profiler(prof, spans: list) -> Trace:
    """The Trace of a finished ``torch.profiler.profile`` and the harness's
    spans (Span with times from ``time.perf_counter_ns`` marks that were
    also written as ``portbench.<kind>`` ranges): the spans are placed on
    the profiler's clock by their ranges' start and end, in order."""
    ops, host, marks = [], [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation() and b > a:
                ops.append((a, b, name))
        elif name.startswith(SPAN_PREFIX):
            marks.append((a, b, name))
        elif b > a:
            host.append((a, b, name))
    marks.sort()
    if len(marks) != len(spans):
        raise RuntimeError(f"the profiler holds {len(marks)} spans of the harness, "
                           f"the harness made {len(spans)}")
    placed = [Span(s.kind, a, b, s.shape) for s, (a, b, _) in zip(spans, marks)]
    return Trace(ops=sorted(ops), host=sorted(host), spans=placed)
