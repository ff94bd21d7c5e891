"""Latency statistics, per-stage timing, deadline policies and online
latency predictors."""
from .deadline import DeadlinePolicy, KalmanDeadline, MeanDeadline, PercentileDeadline, \
    WorstObserved
from .predictor import FeaturePredictor, GaussianPredictor, KalmanPredictor, Prediction, \
    rolling_eval
from .stats import LatencySummary, Welford, summarize
from .timing import StageRecord, StageTimer, TimelineRecorder, fence, timed_stage, to_host

__all__ = [
    "DeadlinePolicy",
    "KalmanDeadline",
    "MeanDeadline",
    "PercentileDeadline",
    "WorstObserved",
    "LatencySummary",
    "Welford",
    "summarize",
    "StageRecord",
    "StageTimer",
    "TimelineRecorder",
    "fence",
    "timed_stage",
    "to_host",
    "FeaturePredictor",
    "GaussianPredictor",
    "KalmanPredictor",
    "Prediction",
    "rolling_eval",
]
