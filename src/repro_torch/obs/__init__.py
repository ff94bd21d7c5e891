"""Unified variance-attribution observatory (the port of ``repro.obs``;
all of it is framework-free except the span fence).

One tracer, one metrics hub, one attribution sample log — shared by
every subsystem so a cross-stream timeline and per-axis variance report
exist for any run:

* :mod:`repro_torch.obs.span` — preallocated ring-buffer span tracer with an
  injected (SimClock-compatible) clock;
* :mod:`repro_torch.obs.sketch` — P² and mergeable log-histogram quantile
  sketches;
* :mod:`repro_torch.obs.metrics` — Welford+sketch per (stream, stage, rung,
  batch-size) key;
* :mod:`repro_torch.obs.export` — Chrome ``trace_event`` JSON for Perfetto;
* :mod:`repro_torch.obs.attribution` — law-of-total-variance decomposition of
  frame latency over the paper's six axes;
* :mod:`repro_torch.obs.dashboard` — periodic text dashboard.

:class:`Observatory` bundles the pieces and is the object the engines
accept as ``obs=``.  It is pure observation: attaching one never changes
scheduling, rung choice, or a virtual-time replay's output.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

from .attribution import (FrameSample, VariationAttribution,
                                   attribute)
from .dashboard import Dashboard, render_table
from .export import (to_chrome_trace, validate_chrome_trace,
                              write_chrome_trace)
from .metrics import MetricKey, MetricsHub, StageMetrics
from .sketch import LatencySketch, P2Quantile
from .span import AXES, DEFAULT_CAPACITY, Span, SpanTracer

__all__ = [
    "Observatory",
    "AXES",
    "Span",
    "SpanTracer",
    "DEFAULT_CAPACITY",
    "P2Quantile",
    "LatencySketch",
    "MetricKey",
    "StageMetrics",
    "MetricsHub",
    "to_chrome_trace",
    "write_chrome_trace",
    "validate_chrome_trace",
    "FrameSample",
    "VariationAttribution",
    "attribute",
    "Dashboard",
    "render_table",
]


class Observatory:
    """Tracer + metrics hub + frame-sample log behind one handle."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        self.tracer = SpanTracer(capacity=capacity, clock=clock)
        self.metrics = MetricsHub()
        self.frames: list[FrameSample] = []

    # -------- clock --------
    @property
    def clock(self) -> Callable[[], float]:
        return self.tracer.clock

    def bind_clock(self, clock: Callable[[], float]) -> None:
        """Point the tracer at a different clock (the replayer binds the
        episode SimClock here so traces live on the virtual timeline)."""
        self.tracer.clock = clock

    # -------- recording --------
    def emit(self, span: Span) -> None:
        """Feed an already-recorded span to the metrics hub too."""
        if span.t1 > span.t0:
            self.metrics.observe_span(span)

    def record(self, *args, **kwargs) -> Span:
        """``tracer.record`` + metrics feed in one call."""
        span = self.tracer.record(*args, **kwargs)
        self.emit(span)
        return span

    def sample(self, frame: FrameSample) -> None:
        """Log one served frame for later axis attribution."""
        self.frames.append(frame)

    # -------- reports --------
    def attribution(self, frames: Optional[Iterable[FrameSample]] = None,
                    ) -> VariationAttribution:
        return attribute(self.frames if frames is None else frames)

    def chrome_trace(self, process_label: str = "repro") -> dict:
        return to_chrome_trace(self.tracer.spans(),
                               process_label=process_label)

    def write_trace(self, path: str, process_label: str = "repro") -> dict:
        return write_chrome_trace(self.tracer.spans(), path,
                                  process_label=process_label)

    def dashboard(self, **kwargs) -> Dashboard:
        return Dashboard(self.metrics, self.tracer, **kwargs)
