"""Variance decomposition — attributing end-to-end latency variance to
pipeline stages (the quantitative core behind the paper's Table VI and the
"inference-dominated vs post-processing-dominated" classification,
Insight 3).  A copy of the reference's ``repro/core/variance.py``.

For a pipeline whose end-to-end latency is the sum of stage latencies,
Var(T) = sum_i Var(S_i) + 2 * sum_{i<j} Cov(S_i, S_j).  We report each
stage's *covariance share*  Cov(S_i, T) / Var(T), which sums to 1 across
stages (including cross terms) and is the natural "how much of the variance
does this stage explain" number.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from .stats import pearson
from .timing import TimelineRecorder

__all__ = ["StageAttribution", "VarianceDecomposition", "decompose", "classify"]


@dataclasses.dataclass(frozen=True)
class StageAttribution:
    stage: str
    variance: float
    covariance_share: float  # Cov(stage, total) / Var(total); sums to 1
    corr_end_to_end: float   # the paper's Table VI number


@dataclasses.dataclass(frozen=True)
class VarianceDecomposition:
    total_variance: float
    attributions: tuple[StageAttribution, ...]

    def dominant(self) -> StageAttribution:
        return max(self.attributions, key=lambda a: a.covariance_share)

    def as_rows(self) -> list[dict]:
        return [dataclasses.asdict(a) for a in self.attributions]


def decompose(recorder: TimelineRecorder) -> VarianceDecomposition:
    stages = recorder.stages()
    total = recorder.end_to_end_series()
    var_total = float(np.var(total))
    attributions = []
    for st in stages:
        series = recorder.stage_series(st)
        var_s = float(np.var(series))
        if var_total > 0:
            cov = float(np.cov(series, total, bias=True)[0, 1])
            share = cov / var_total
        else:
            share = 0.0
        attributions.append(
            StageAttribution(
                stage=st,
                variance=var_s,
                covariance_share=share,
                corr_end_to_end=pearson(series, total),
            )
        )
    return VarianceDecomposition(var_total, tuple(attributions))


def classify(recorder: TimelineRecorder, threshold: float = 0.5) -> str:
    """Paper Insight 3 classifier.

    Returns ``"inference-dominated"`` or ``"post_processing-dominated"``
    (or ``"<stage>-dominated"`` generally): the stage with the largest
    covariance share, provided it exceeds ``threshold``; otherwise
    ``"mixed"``.
    """
    dec = decompose(recorder)
    dom = dec.dominant()
    if dom.covariance_share < threshold:
        return "mixed"
    return f"{dom.stage}-dominated"


def explained_by_meta(
    recorder: TimelineRecorder, key: str, stage: str = "post_processing"
) -> float:
    """R^2 of a metadata series (e.g. proposal count) against a stage
    latency — quantifies the paper's Fig. 11 claim (corr constantly > 0.89
    between #proposals and post-processing time)."""
    r = recorder.correlation_meta(key, stage)
    return r * r


def variance_reduction(
    before: Sequence[float] | np.ndarray, after: Sequence[float] | np.ndarray
) -> Mapping[str, float]:
    """Summary of a mitigation's effect (used by the static-shape benchmark):
    ratio of c_v, range, and p99/p50 tail before vs after."""
    b = np.asarray(before, dtype=np.float64)
    a = np.asarray(after, dtype=np.float64)

    def _cv(x: np.ndarray) -> float:
        m = x.mean()
        return float(x.std() / m) if m else float("nan")

    def _rng(x: np.ndarray) -> float:
        return float(x.max() - x.min()) if x.size else float("nan")

    def _tail(x: np.ndarray) -> float:
        p50 = np.percentile(x, 50)
        return float(np.percentile(x, 99) / p50) if p50 else float("nan")

    out = {
        "cv_before": _cv(b),
        "cv_after": _cv(a),
        "range_before": _rng(b),
        "range_after": _rng(a),
        "tail99_before": _tail(b),
        "tail99_after": _tail(a),
    }
    out["cv_reduction_x"] = (
        out["cv_before"] / out["cv_after"] if out["cv_after"] else float("inf")
    )
    return out
