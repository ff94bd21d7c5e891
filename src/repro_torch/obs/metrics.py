"""Streaming per-key metrics keyed on (stream, stage, rung, batch_size).

The hub is the aggregation side of the observatory: spans (or raw
durations from the ``TimelineRecorder`` adapter) feed a
:class:`StageMetrics` per key holding a Welford accumulator (mean/CV,
mergeable via Chan's parallel update in ``core.stats``) and a
:class:`LatencySketch` (mergeable quantiles).  Buckets roll up exactly:
``hub.rollup(lambda k: k.stream)`` folds rung/batch sub-buckets into
per-stream totals by sketch merge + Welford merge, with no resampling
error beyond the sketch's fixed bin width.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Hashable, Optional

from ..core.stats import Welford
from .sketch import LatencySketch
from .span import Span

__all__ = ["MetricKey", "StageMetrics", "MetricsHub"]


@dataclasses.dataclass(frozen=True, order=True)
class MetricKey:
    stream: str = ""
    stage: str = ""
    rung: str = ""
    batch_size: int = 0


class StageMetrics:
    """Welford mean/CV + quantile sketch for one metric key."""

    def __init__(self, lo: float = 1e-6, gamma: float = 1.02,
                 n_bins: int = 2048) -> None:
        self.welford = Welford()
        self.sketch = LatencySketch(lo=lo, gamma=gamma, n_bins=n_bins)

    def update(self, x: float) -> None:
        x = float(x)
        if not math.isfinite(x):
            # the sketch counts it in .dropped; keep the Welford moments
            # finite too (one NaN would poison mean/CV forever)
            self.sketch.update(x)
            return
        self.welford.update(x)
        self.sketch.update(x)

    def merge(self, other: "StageMetrics") -> "StageMetrics":
        self.welford = self.welford.merge(other.welford)  # Chan, out-of-place
        self.sketch.merge(other.sketch)
        return self

    @property
    def count(self) -> int:
        return self.sketch.count

    @property
    def dropped(self) -> int:
        return self.sketch.dropped

    @property
    def mean(self) -> float:
        return self.welford.mean

    @property
    def cv(self) -> float:
        m = self.welford.mean
        return (self.welford.std / m) if m > 0 else 0.0

    def quantile(self, q: float) -> float:
        return self.sketch.quantile(q)

    def summary(self) -> dict:
        return {
            "count": self.count,
            "dropped": self.dropped,
            "mean": self.mean,
            "cv": self.cv,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsHub:
    """Dictionary of :class:`StageMetrics` keyed by :class:`MetricKey`.

    ``observe_span`` is the tracer-side feed; ``observe`` is the raw
    adapter feed (``TimelineRecorder.observe`` forwards here so legacy
    recorders and the tracer share one aggregation path).
    """

    def __init__(self, lo: float = 1e-6, gamma: float = 1.02,
                 n_bins: int = 2048) -> None:
        self._params = (lo, gamma, n_bins)
        self._by_key: dict[MetricKey, StageMetrics] = {}

    def _slot(self, key: MetricKey) -> StageMetrics:
        m = self._by_key.get(key)
        if m is None:
            lo, gamma, n_bins = self._params
            m = self._by_key[key] = StageMetrics(lo, gamma, n_bins)
        return m

    def observe(self, stream: str, stage: str, value: float, *,
                rung: str = "", batch_size: int = 0) -> None:
        self._slot(MetricKey(stream, stage, rung, batch_size)).update(value)

    def observe_span(self, span: Span) -> None:
        self._slot(MetricKey(span.stream, span.name, span.rung,
                             span.batch_size)).update(span.duration)

    def get(self, key: MetricKey) -> Optional[StageMetrics]:
        return self._by_key.get(key)

    def keys(self) -> list[MetricKey]:
        return sorted(self._by_key)

    def __len__(self) -> int:
        return len(self._by_key)

    def rollup(self, group: Callable[[MetricKey], Hashable]) -> dict:
        """Merge buckets sharing ``group(key)`` into fresh StageMetrics.

        Exact under the sketch family's fixed edges: the rolled-up p99
        equals the p99 of a single sketch fed every observation.
        """
        out: dict[Hashable, StageMetrics] = {}
        lo, gamma, n_bins = self._params
        for key in sorted(self._by_key):
            g = group(key)
            if g not in out:
                out[g] = StageMetrics(lo, gamma, n_bins)
            out[g].merge(self._by_key[key])
        return out

    def table(self) -> list[dict]:
        """Flat per-key summaries, deterministically ordered."""
        rows = []
        for key in self.keys():
            row = {"stream": key.stream, "stage": key.stage,
                   "rung": key.rung, "batch_size": key.batch_size}
            row.update(self._by_key[key].summary())
            rows.append(row)
        return rows
