"""Streaming quantile sketches for per-key latency distributions.

Two estimators with different trade-offs:

* :class:`P2Quantile` — the Jain & Chlamtac P² algorithm: O(1) memory
  (five markers), one quantile per instance, *not* mergeable.  Used
  where a single live quantile is wanted cheaply (dashboard p99 per
  stream).
* :class:`LatencySketch` — a log-bucketed streaming histogram over
  **fixed global bin edges**, so merging two sketches is exact bin-count
  addition and therefore associative and commutative — the property the
  metrics hub needs to fold per-rung buckets into per-stream and fleet
  totals.  Quantiles interpolate within the hit bin; relative error is
  bounded by the bin width (``gamma - 1``, default 2%).

Both track exact min/max so extreme quantiles never leave the observed
range, and q=0/q=1 are exact.
"""
from __future__ import annotations

import math
from typing import Iterable

__all__ = ["P2Quantile", "LatencySketch"]


class P2Quantile:
    """Jain & Chlamtac's P² streaming estimator of a single quantile.

    Keeps five markers whose heights approximate the quantile curve;
    each observation adjusts marker positions with a piecewise-parabolic
    (P²) height update.  Exact until five observations have been seen.
    """

    def __init__(self, q: float) -> None:
        if not 0.0 < q < 1.0:
            raise ValueError(f"q must be in (0, 1), got {q}")
        self.q = q
        self._heights: list[float] = []
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._want = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0]
        self._dwant = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]
        self.count = 0

    def update(self, x: float) -> None:
        self.count += 1
        h = self._heights
        if len(h) < 5:
            h.append(float(x))
            h.sort()
            return
        # locate the cell containing x, clamping the extreme markers
        if x < h[0]:
            h[0] = float(x)
            k = 0
        elif x >= h[4]:
            h[4] = float(x)
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self._pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._dwant[i]
        # adjust the three interior markers
        for i in (1, 2, 3):
            d = self._want[i] - self._pos[i]
            if (d >= 1.0 and self._pos[i + 1] - self._pos[i] > 1.0) or (
                d <= -1.0 and self._pos[i - 1] - self._pos[i] < -1.0
            ):
                d = 1.0 if d > 0 else -1.0
                cand = self._parabolic(i, d)
                if h[i - 1] < cand < h[i + 1]:
                    h[i] = cand
                else:  # fall back to linear when P² leaves the bracket
                    h[i] = self._linear(i, d)
                self._pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, p = self._heights, self._pos
        return h[i] + d / (p[i + 1] - p[i - 1]) * (
            (p[i] - p[i - 1] + d) * (h[i + 1] - h[i]) / (p[i + 1] - p[i])
            + (p[i + 1] - p[i] - d) * (h[i] - h[i - 1]) / (p[i] - p[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        h, p = self._heights, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (p[j] - p[i])

    def value(self) -> float:
        """Current estimate (exact order statistic below 5 samples)."""
        if not self._heights:
            return float("nan")
        if self.count < 5:
            h = sorted(self._heights)
            k = max(0, min(len(h) - 1, math.ceil(self.q * len(h)) - 1))
            return h[k]
        return self._heights[2]


class LatencySketch:
    """Mergeable log-bucketed histogram with fixed global edges.

    Bin ``i`` covers ``[lo * gamma**i, lo * gamma**(i+1))`` with ``lo``
    and ``gamma`` fixed per sketch family, so two sketches built with
    the same parameters share edges exactly and merge by adding counts —
    associative to the bit.  Values at or below ``lo`` (including zero
    and negatives, which cannot happen for latencies but must not crash)
    land in a dedicated underflow bin.
    """

    def __init__(self, lo: float = 1e-6, gamma: float = 1.02,
                 n_bins: int = 2048) -> None:
        if lo <= 0 or gamma <= 1.0 or n_bins < 1:
            raise ValueError("need lo > 0, gamma > 1, n_bins >= 1")
        self.lo = lo
        self.gamma = gamma
        self.n_bins = n_bins
        self._log_gamma = math.log(gamma)
        self._counts: dict[int, int] = {}   # sparse: bin index -> count
        self.count = 0
        self.dropped = 0                     # non-finite samples, kept out
        self.min = math.inf                  # of count/min/max/quantiles
        self.max = -math.inf

    def _bin(self, x: float) -> int:
        if x <= self.lo:
            return -1                        # underflow bin
        i = int(math.log(x / self.lo) / self._log_gamma)
        return min(i, self.n_bins - 1)       # clamp overflow to last bin

    def update(self, x: float) -> None:
        x = float(x)
        if not math.isfinite(x):
            # one NaN completion latency must not kill the hub: count it
            # where the dashboard can see it and keep the histogram clean
            self.dropped += 1
            return
        b = self._bin(x)
        self._counts[b] = self._counts.get(b, 0) + 1
        self.count += 1
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    def extend(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.update(x)

    def merge(self, other: "LatencySketch") -> "LatencySketch":
        """Fold ``other`` into self (exact: bin-count addition)."""
        if (other.lo, other.gamma, other.n_bins) != (self.lo, self.gamma,
                                                     self.n_bins):
            raise ValueError("cannot merge sketches with different edges")
        for i, c in other._counts.items():
            self._counts[i] = self._counts.get(i, 0) + c
        self.count += other.count
        self.dropped += other.dropped
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def copy(self) -> "LatencySketch":
        out = LatencySketch(self.lo, self.gamma, self.n_bins)
        out._counts = dict(self._counts)
        out.count = self.count
        out.dropped = self.dropped
        out.min = self.min
        out.max = self.max
        return out

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile; bounded relative error gamma-1.

        Uses the nearest-rank definition (rank ``ceil(q*n)``), reporting
        the geometric midpoint of the hit bin clamped to [min, max].
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return float("nan")
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i in sorted(self._counts):
            seen += self._counts[i]
            if seen >= rank:
                if i < 0:
                    return max(min(self.lo, self.max), self.min)
                mid = self.lo * self.gamma ** (i + 0.5)
                return max(self.min, min(self.max, mid))
        return self.max

    def to_dict(self) -> dict:
        return {
            "lo": self.lo, "gamma": self.gamma, "n_bins": self.n_bins,
            "count": self.count,
            "dropped": self.dropped,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "counts": {str(i): c for i, c in sorted(self._counts.items())},
        }
