"""Latency predictors (paper §I related work: [51] Gaussian fit, [49]
Kalman estimation).

These are used by the serving engine's admission controller: given the
recent latency stream, predict the next job's latency distribution so the
scheduler can decide whether a job can meet its deadline *before* running
it (the resource-saving the paper argues for).  A copy of the reference's
``repro/core/predictor.py``: the port imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from .stats import Welford

__all__ = ["Prediction", "GaussianPredictor", "KalmanPredictor", "FeaturePredictor"]


@dataclasses.dataclass(frozen=True)
class Prediction:
    mean: float
    std: float

    def quantile(self, q: float) -> float:
        """Gaussian quantile — the paper's [51] approximation."""
        # inverse error function via Winitzki's approximation (no scipy).
        x = 2.0 * q - 1.0
        a = 0.147
        sgn = 1.0 if x >= 0 else -1.0
        ln = math.log(max(1.0 - x * x, 1e-300))
        t1 = 2.0 / (math.pi * a) + ln / 2.0
        erfinv = sgn * math.sqrt(max(math.sqrt(t1 * t1 - ln / a) - t1, 0.0))
        return self.mean + self.std * math.sqrt(2.0) * erfinv

    def prob_exceeds(self, deadline: float) -> float:
        if self.std <= 0:
            return 0.0 if self.mean <= deadline else 1.0
        z = (deadline - self.mean) / (self.std * math.sqrt(2.0))
        return 0.5 * math.erfc(z)


class GaussianPredictor:
    """Fits a stationary Gaussian to the stream ([51]: inference time is
    approximately Gaussian on mobile devices).  The paper notes this
    performs poorly when variations are enormous — our benchmarks show
    exactly that on the two-stage pipeline."""

    name = "gaussian"

    def __init__(self) -> None:
        self._w = Welford()

    def observe(self, latency: float) -> None:
        self._w.update(latency)

    def predict(self) -> Prediction:
        if not self._w.n:
            return Prediction(float("nan"), float("nan"))
        return Prediction(self._w.mean, self._w.std if self._w.n > 1 else 0.0)


class KalmanPredictor:
    """Non-stationary tracker (ALERT [49]): latent mean follows a random
    walk; adapts when the workload drifts (e.g. scene density changes)."""

    name = "kalman"

    def __init__(self, q: float = 1e-6, r: float = 1e-4) -> None:
        self.q = q
        self.r = r
        self._x: float | None = None
        self._p = 1.0
        self._resid = Welford()

    def observe(self, latency: float) -> None:
        z = float(latency)
        if self._x is None:
            self._x, self._p = z, self.r
            return
        self._p += self.q
        pred = self._x
        k = self._p / (self._p + self.r)
        self._x += k * (z - self._x)
        self._p *= 1.0 - k
        self._resid.update(z - pred)

    def predict(self) -> Prediction:
        if self._x is None:
            return Prediction(float("nan"), float("nan"))
        std = math.sqrt(self._p + self.r)
        if self._resid.n > 4:
            std = max(std, self._resid.std)
        return Prediction(self._x, std)


class FeaturePredictor:
    """Beyond-paper: linear model latency ~ a + b * feature, where feature
    is an observable pre-execution signal (e.g. the *previous* frame's
    proposal count — scenes are temporally coherent, so it is predictive).

    This operationalizes the paper's Insight 1/3: if proposal count drives
    post-processing time, a scheduler can predict per-frame latency instead
    of budgeting for the worst case.  Ridge-regularized online least squares.
    """

    name = "feature"

    def __init__(self, ridge: float = 1e-6) -> None:
        self.ridge = ridge
        # sufficient statistics for 2-param least squares
        self._sxx = 0.0
        self._sx = 0.0
        self._sxy = 0.0
        self._sy = 0.0
        self._n = 0
        self._resid = Welford()

    def observe(self, latency: float, feature: float) -> None:
        x, y = float(feature), float(latency)
        if self._n >= 2:
            pred = self.predict(x).mean
            self._resid.update(y - pred)
        self._sxx += x * x
        self._sx += x
        self._sxy += x * y
        self._sy += y
        self._n += 1

    def _coeffs(self) -> tuple[float, float]:
        n = self._n
        det = (self._sxx + self.ridge) * n - self._sx * self._sx
        if n < 2 or abs(det) < 1e-30:
            mean = self._sy / n if n else 0.0
            return mean, 0.0
        b = (self._sxy * n - self._sx * self._sy) / det
        a = (self._sy - b * self._sx) / n
        return a, b

    def predict(self, feature: float) -> Prediction:
        if self._n == 0:
            return Prediction(float("nan"), float("nan"))
        a, b = self._coeffs()
        std = self._resid.std if self._resid.n > 4 else 0.0
        if std != std:  # NaN
            std = 0.0
        return Prediction(a + b * float(feature), std)


def rolling_eval(
    predictor, trace: Sequence[float], features: Sequence[float] | None = None
) -> dict:
    """One-step-ahead evaluation: observe t_i, predict t_{i+1}.  Returns
    MAE and the fraction of jobs within the predicted 99% quantile."""
    xs = [float(x) for x in trace]
    errs = []
    covered = 0
    scored = 0
    for i, x in enumerate(xs):
        if i > 0:
            if features is not None:
                p = predictor.predict(features[i])
            else:
                p = predictor.predict()
            if p.mean == p.mean:  # not NaN
                errs.append(abs(p.mean - x))
                scored += 1
                if p.std == p.std and x <= p.quantile(0.99):
                    covered += 1
        if features is not None:
            predictor.observe(x, features[i])
        else:
            predictor.observe(x)
    return {
        "mae": float(np.mean(errs)) if errs else float("nan"),
        "coverage99": covered / scored if scored else float("nan"),
        "n": scored,
    }
