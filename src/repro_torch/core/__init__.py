"""Latency statistics, per-stage timing and deadline policies."""
from .deadline import DeadlinePolicy, KalmanDeadline, MeanDeadline, PercentileDeadline, \
    WorstObserved
from .stats import LatencySummary, Welford, summarize
from .timing import StageRecord, StageTimer, TimelineRecorder, fence, timed_stage

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
]
