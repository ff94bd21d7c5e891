"""Deadline policies (paper Insight 4, §III-E).

The paper's observation: real-time schedulers set deadlines from the *worst
observed* execution time, which wastes enormous reserved budget (LaneNet:
deadline 340ms while 95% of jobs finish < 160ms).  Mean-based deadlines
waste less but miss more.  A policy consumes a latency stream online
(``observe``) and exposes the current ``deadline()``.

The four policies the serving launcher offers, copied from the reference's
``repro/core/deadline.py`` (the port imports nothing of the reference);
``DynamicDeadline`` and the trace evaluator come with a later slice.
"""
from __future__ import annotations

import math
from collections import deque

import numpy as np

from .stats import Welford

__all__ = [
    "DeadlinePolicy",
    "WorstObserved",
    "MeanDeadline",
    "PercentileDeadline",
    "KalmanDeadline",
]


class DeadlinePolicy:
    """Online deadline estimator."""

    name = "base"

    def observe(self, latency: float) -> None:
        raise NotImplementedError

    def deadline(self) -> float:
        raise NotImplementedError

    def reset(self) -> None:
        """Clear observed state while preserving constructor configuration
        (margins, window sizes, noise parameters survive a reset)."""
        raise NotImplementedError


class WorstObserved(DeadlinePolicy):
    """The paper's status-quo: deadline = worst observed execution time
    (optionally with a safety margin)."""

    name = "worst_observed"

    def __init__(self, margin: float = 1.0) -> None:
        self.margin = margin
        self._worst = 0.0

    def observe(self, latency: float) -> None:
        self._worst = max(self._worst, float(latency))

    def deadline(self) -> float:
        return self._worst * self.margin if self._worst else math.inf

    def reset(self) -> None:
        self._worst = 0.0


class MeanDeadline(DeadlinePolicy):
    """Deadline-2 in the paper: the running average."""

    name = "mean"

    def __init__(self, margin: float = 1.0) -> None:
        self.margin = margin
        self._w = Welford()

    def observe(self, latency: float) -> None:
        self._w.update(latency)

    def deadline(self) -> float:
        if not self._w.n:
            return math.inf
        return self._w.mean * self.margin

    def reset(self) -> None:
        self._w = Welford()


class PercentileDeadline(DeadlinePolicy):
    """pXX over a sliding window — the natural middle ground the paper's
    LaneNet example implies (95th pct would save ~180ms/job)."""

    name = "percentile"

    def __init__(self, q: float = 95.0, window: int = 256) -> None:
        self.q = q
        self._buf: deque[float] = deque(maxlen=window)

    @property
    def window(self) -> int:
        """Single source of truth: the deque's own bound."""
        return self._buf.maxlen

    def observe(self, latency: float) -> None:
        self._buf.append(float(latency))

    def deadline(self) -> float:
        if not self._buf:
            return math.inf
        return float(np.percentile(np.asarray(self._buf), self.q))

    def reset(self) -> None:
        self._buf.clear()


class KalmanDeadline(DeadlinePolicy):
    """Scalar Kalman filter over latency (ALERT [49] style): track the
    latent mean with process noise q and measurement noise r; deadline =
    estimate + k_sigma * sqrt(estimate variance + r)."""

    name = "kalman"

    def __init__(self, q: float = 1e-6, r: float = 1e-4, k_sigma: float = 3.0) -> None:
        self.q = q
        self.r = r
        self.k_sigma = k_sigma
        self._x: float | None = None  # state estimate
        self._p = 1.0                 # estimate variance

    def observe(self, latency: float) -> None:
        z = float(latency)
        if self._x is None:
            self._x, self._p = z, self.r
            return
        # predict
        self._p += self.q
        # update
        k = self._p / (self._p + self.r)
        self._x += k * (z - self._x)
        self._p *= 1.0 - k

    def deadline(self) -> float:
        if self._x is None:
            return math.inf
        return self._x + self.k_sigma * math.sqrt(self._p + self.r)

    def reset(self) -> None:
        self._x = None
        self._p = 1.0
