"""Deadline policies and their evaluation (paper Insight 4, §III-E).

The paper's observation: real-time schedulers set deadlines from the *worst
observed* execution time, which wastes enormous reserved budget (LaneNet:
deadline 340ms while 95% of jobs finish < 160ms).  Mean-based deadlines
waste less but miss more.  We make deadline selection a first-class policy
object evaluated on recorded traces, including the two adaptive estimators
the paper cites: ALERT's Kalman filter [49] and D3's dynamic deadlines [21].

A policy consumes a latency stream online (``observe``) and exposes the
current ``deadline()``.  ``evaluate`` replays a trace and reports the two
costs the paper trades off:

* miss rate     — fraction of jobs exceeding the then-current deadline,
* waste         — mean reserved-but-unused time, E[max(deadline - t, 0)].

Copied from the reference's ``repro/core/deadline.py`` (the port imports
nothing of the reference).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Iterable, Sequence

import numpy as np

from .stats import Welford

__all__ = [
    "DeadlinePolicy",
    "WorstObserved",
    "MeanDeadline",
    "PercentileDeadline",
    "KalmanDeadline",
    "DynamicDeadline",
    "DeadlineReport",
    "evaluate",
    "POLICIES",
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


class DynamicDeadline(DeadlinePolicy):
    """D3 [21] style: the deadline is not a property of the task but of the
    *situation* — here modeled as an exponentially-weighted recent mean
    scaled by a criticality factor supplied per-job via ``set_criticality``
    (1.0 = nominal; <1 tightens the deadline when the scene is critical)."""

    name = "dynamic"

    def __init__(self, alpha: float = 0.1, headroom: float = 1.5) -> None:
        self.alpha = alpha
        self.headroom = headroom
        self._ema: float | None = None
        self._criticality = 1.0

    def set_criticality(self, c: float) -> None:
        self._criticality = float(c)

    def observe(self, latency: float) -> None:
        z = float(latency)
        self._ema = z if self._ema is None else (1 - self.alpha) * self._ema + self.alpha * z

    def deadline(self) -> float:
        if self._ema is None:
            return math.inf
        return self._ema * self.headroom * self._criticality

    def reset(self) -> None:
        self._ema = None
        self._criticality = 1.0


@dataclasses.dataclass(frozen=True)
class DeadlineReport:
    policy: str
    miss_rate: float
    mean_waste: float          # E[max(deadline - latency, 0)] over met jobs
    mean_deadline: float
    p99_overshoot: float       # p99 of latency - deadline over missed jobs (0 if none)

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


def evaluate(
    policy: DeadlinePolicy,
    trace: Sequence[float] | Iterable[float],
    warmup: int = 8,
) -> DeadlineReport:
    """Replay a latency trace through a policy.

    The first ``warmup`` observations seed the policy without being scored
    (a fresh policy has no basis for a deadline — the paper likewise sets
    deadlines from prior profiling).
    """
    xs = [float(x) for x in trace]
    misses: list[float] = []
    wastes: list[float] = []
    deadlines: list[float] = []
    for i, x in enumerate(xs):
        if i >= warmup:
            d = policy.deadline()
            deadlines.append(d)
            if x > d:
                misses.append(x - d)
            else:
                wastes.append(d - x)
        policy.observe(x)
    n_scored = max(len(xs) - warmup, 0)
    return DeadlineReport(
        policy=policy.name,
        miss_rate=(len(misses) / n_scored) if n_scored else float("nan"),
        mean_waste=float(np.mean(wastes)) if wastes else 0.0,
        mean_deadline=float(np.mean(deadlines)) if deadlines else float("nan"),
        p99_overshoot=float(np.percentile(misses, 99)) if misses else 0.0,
    )


def POLICIES() -> list[DeadlinePolicy]:
    """Fresh instances of every built-in policy (benchmark convenience)."""
    return [
        WorstObserved(),
        MeanDeadline(),
        PercentileDeadline(q=95.0),
        PercentileDeadline(q=99.0),
        KalmanDeadline(),
        DynamicDeadline(),
    ]
