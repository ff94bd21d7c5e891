"""Latency statistics, per-stage timing, variance attribution, deadline
policies and online latency predictors."""
from .deadline import POLICIES, DeadlinePolicy, DeadlineReport, DynamicDeadline, \
    KalmanDeadline, MeanDeadline, PercentileDeadline, WorstObserved, evaluate
from .predictor import FeaturePredictor, GaussianPredictor, KalmanPredictor, Prediction, \
    rolling_eval
from .stats import LatencySummary, Welford, summarize
from .timing import STAGE_AXES, StageRecord, StageTimer, TimelineRecorder, fence, instrument, \
    run_pipeline, timed_stage, to_host
from .variance import VarianceDecomposition, classify, decompose, variance_reduction

__all__ = [
    "DeadlinePolicy",
    "DeadlineReport",
    "DynamicDeadline",
    "POLICIES",
    "evaluate",
    "KalmanDeadline",
    "MeanDeadline",
    "PercentileDeadline",
    "WorstObserved",
    "LatencySummary",
    "Welford",
    "summarize",
    "STAGE_AXES",
    "StageRecord",
    "StageTimer",
    "TimelineRecorder",
    "fence",
    "instrument",
    "run_pipeline",
    "timed_stage",
    "to_host",
    "VarianceDecomposition",
    "classify",
    "decompose",
    "variance_reduction",
    "FeaturePredictor",
    "GaussianPredictor",
    "KalmanPredictor",
    "Prediction",
    "rolling_eval",
]
