"""Latency statistics used throughout the paper's analysis.

The paper characterizes inference-time variation with four estimators:

* ``range`` — max - min (paper Eq. 1),
* ``coefficient of variation`` c_v = sigma / mu (paper Eq. 2),
* percentiles (Fig. 2, Fig. 12),
* Pearson correlation between stage latencies / proposal counts and the
  end-to-end latency (Fig. 5, Table VI).

Everything here is plain numpy on host-side float64 — these run on
recorded wall-clock traces, outside the device work, exactly like the
paper's offline analysis of cProfiler logs.  (A copy of the reference's
``repro/core/stats.py``: the port imports nothing of the reference.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, Sequence

import numpy as np

__all__ = [
    "LatencySummary",
    "latency_range",
    "coefficient_of_variation",
    "json_num",
    "pearson",
    "summarize",
    "Welford",
    "bootstrap_ci",
    "tail_ratio",
]


def json_num(x):
    """JSON-safe numeric: NaN/inf → None, else rounded to 9 places so
    serialized reports are stable and small.  Every report that may end
    up in ``BENCH_results.json`` or a golden fixture must route its
    floats through here — ``json.dumps`` happily emits the non-strict
    ``NaN``/``Infinity`` literals that strict parsers reject."""
    if x is None:
        return None
    x = float(x)
    if not math.isfinite(x):
        return None
    return round(x, 9)


def _as_array(xs: Iterable[float]) -> np.ndarray:
    arr = np.asarray(list(xs) if not isinstance(xs, np.ndarray) else xs, dtype=np.float64)
    if arr.ndim != 1:
        arr = arr.reshape(-1)
    return arr


def latency_range(xs: Iterable[float]) -> float:
    """Paper Eq. (1): R = max(t_i) - min(t_i)."""
    arr = _as_array(xs)
    if arr.size == 0:
        return float("nan")
    return float(arr.max() - arr.min())


def coefficient_of_variation(xs: Iterable[float]) -> float:
    """Paper Eq. (2): c_v = sigma / mu (population sigma, as in the paper)."""
    arr = _as_array(xs)
    if arr.size == 0:
        return float("nan")
    mu = float(arr.mean())
    if mu == 0.0:
        return float("nan")
    return float(arr.std() / mu)


def pearson(xs: Iterable[float], ys: Iterable[float]) -> float:
    """Pearson correlation coefficient (paper Fig. 5 / Table VI).

    Returns 0.0 for degenerate (zero-variance) inputs rather than NaN so the
    "one-stage models have a *static* number of objects" case (constant
    proposal count) reads as uncorrelated, matching the paper's narrative.
    """
    x = _as_array(xs)
    y = _as_array(ys)
    if x.size != y.size:
        raise ValueError(f"length mismatch: {x.size} vs {y.size}")
    if x.size < 2:
        return 0.0
    xd = x - x.mean()
    yd = y - y.mean()
    denom = math.sqrt(float(xd @ xd) * float(yd @ yd))
    if denom == 0.0:
        return 0.0
    return float(xd @ yd) / denom


@dataclasses.dataclass(frozen=True)
class LatencySummary:
    """The per-model row of the paper's Table I, plus percentiles (Fig. 2)."""

    n: int
    mean: float
    std: float
    min: float
    max: float
    range: float
    range_over_mean_pct: float
    cv: float
    p50: float
    p80: float
    p95: float
    p99: float

    def as_row(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"n={self.n} mean={self.mean:.3f} range={self.range:.3f} "
            f"(range/mean={self.range_over_mean_pct:.1f}%) cv={self.cv:.3f} "
            f"p50={self.p50:.3f} p99={self.p99:.3f}"
        )


def summarize(xs: Iterable[float]) -> LatencySummary:
    arr = _as_array(xs)
    if arr.size == 0:
        nan = float("nan")
        return LatencySummary(0, nan, nan, nan, nan, nan, nan, nan, nan, nan, nan, nan)
    mean = float(arr.mean())
    rng = float(arr.max() - arr.min())
    p50, p80, p95, p99 = (float(np.percentile(arr, q)) for q in (50, 80, 95, 99))
    return LatencySummary(
        n=int(arr.size),
        mean=mean,
        std=float(arr.std()),
        min=float(arr.min()),
        max=float(arr.max()),
        range=rng,
        range_over_mean_pct=(100.0 * rng / mean) if mean else float("nan"),
        cv=float(arr.std() / mean) if mean else float("nan"),
        p50=p50,
        p80=p80,
        p95=p95,
        p99=p99,
    )


class Welford:
    """Streaming mean/variance — used by the serving engine so deadline
    policies can adapt online without retaining full traces."""

    def __init__(self) -> None:
        self.n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._min = math.inf
        self._max = -math.inf

    def update(self, x: float) -> None:
        x = float(x)
        self.n += 1
        delta = x - self._mean
        self._mean += delta / self.n
        self._m2 += delta * (x - self._mean)
        self._min = min(self._min, x)
        self._max = max(self._max, x)

    def update_many(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.update(x)

    @property
    def mean(self) -> float:
        return self._mean if self.n else float("nan")

    @property
    def variance(self) -> float:
        """Population variance, matching the paper's sigma."""
        return self._m2 / self.n if self.n else float("nan")

    @property
    def std(self) -> float:
        v = self.variance
        return math.sqrt(v) if v == v else float("nan")

    @property
    def cv(self) -> float:
        if not self.n or self._mean == 0.0:
            return float("nan")
        return self.std / self._mean

    @property
    def min(self) -> float:
        return self._min if self.n else float("nan")

    @property
    def max(self) -> float:
        return self._max if self.n else float("nan")

    @property
    def range(self) -> float:
        return (self._max - self._min) if self.n else float("nan")

    def merge(self, other: "Welford") -> "Welford":
        """Chan parallel-merge; used when fusing per-shard timing streams."""
        out = Welford()
        out.n = self.n + other.n
        if out.n == 0:
            return out
        delta = other._mean - self._mean
        out._mean = self._mean + delta * other.n / out.n
        out._m2 = self._m2 + other._m2 + delta * delta * self.n * other.n / out.n
        out._min = min(self._min, other._min)
        out._max = max(self._max, other._max)
        return out


def bootstrap_ci(
    xs: Sequence[float],
    stat=np.mean,
    n_boot: int = 1000,
    alpha: float = 0.05,
    seed: int = 0,
) -> tuple[float, float]:
    """Bootstrap confidence interval for a latency statistic.

    The paper reports point estimates only; we add CIs so EXPERIMENTS.md
    claims ("c_v decreased") are distinguishable from noise.
    """
    arr = _as_array(xs)
    if arr.size == 0:
        return (float("nan"), float("nan"))
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, arr.size, size=(n_boot, arr.size))
    stats = np.asarray([stat(arr[i]) for i in idx])
    lo = float(np.percentile(stats, 100 * alpha / 2))
    hi = float(np.percentile(stats, 100 * (1 - alpha / 2)))
    return (lo, hi)


def tail_ratio(xs: Iterable[float], p: float = 99.0) -> float:
    """pXX / p50 — the paper's 'long tail' indicator (Fig. 16)."""
    arr = _as_array(xs)
    if arr.size == 0:
        return float("nan")
    p50 = float(np.percentile(arr, 50))
    if p50 == 0:
        return float("nan")
    return float(np.percentile(arr, p)) / p50


def summaries_table(traces: Mapping[str, Sequence[float]]) -> list[dict]:
    """Build a Table-I-style list of rows from named latency traces."""
    rows = []
    for name, xs in traces.items():
        row = {"name": name}
        row.update(summarize(xs).as_row())
        rows.append(row)
    return rows
