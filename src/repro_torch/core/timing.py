"""Per-stage timeline instrumentation — the paper's cProfiler breakdown
(Fig. 3: read → pre-process → inference → post-process) for PyTorch.

CUDA work is launched asynchronously, so ``time.perf_counter()`` around a
launch measures the launch, not the work.  ``timed_stage`` fences with
``torch.cuda.synchronize`` on the device of each CUDA tensor it is given,
so the recorded interval is the device-inclusive stage latency; CPU
tensors need no fence.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Any, Callable, Iterator

import numpy as np
import torch

from .stats import LatencySummary, Welford, pearson, summarize

__all__ = [
    "StageRecord",
    "TimelineRecorder",
    "StageTimer",
    "timed_stage",
    "fence",
]


def _tensors(values: Any) -> Iterator[torch.Tensor]:
    if isinstance(values, torch.Tensor):
        yield values
    elif isinstance(values, dict):
        for v in values.values():
            yield from _tensors(v)
    elif isinstance(values, (list, tuple)):
        for v in values:
            yield from _tensors(v)


def fence(*values: Any) -> None:
    """Wait for the work on every CUDA device that holds one of the
    tensors in ``values`` (nested lists, tuples and dicts are walked); a
    no-op for CPU tensors."""
    devices = {t.device for t in _tensors(values) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class StageRecord:
    """One job's timeline: stage → seconds, plus free-form scalar metadata."""

    stages: dict[str, float] = dataclasses.field(default_factory=dict)
    meta: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def end_to_end(self) -> float:
        return sum(self.stages.values())


class TimelineRecorder:
    """Accumulates StageRecords across jobs and answers the paper's
    questions: per-stage summaries and correlation of stage latencies with
    end-to-end latency."""

    def __init__(self) -> None:
        self.records: list[StageRecord] = []
        self._welford: dict[str, Welford] = defaultdict(Welford)

    def add(self, record: StageRecord) -> None:
        self.records.append(record)
        for k, v in record.stages.items():
            self._welford[k].update(v)
        self._welford["end_to_end"].update(record.end_to_end)

    def stage_series(self, stage: str) -> np.ndarray:
        return np.asarray([r.stages.get(stage, 0.0) for r in self.records])

    def meta_series(self, key: str) -> np.ndarray:
        return np.asarray([r.meta.get(key, 0.0) for r in self.records])

    def end_to_end_series(self) -> np.ndarray:
        return np.asarray([r.end_to_end for r in self.records])

    def stages(self) -> list[str]:
        keys: list[str] = []
        for r in self.records:
            for k in r.stages:
                if k not in keys:
                    keys.append(k)
        return keys

    def summary(self, stage: str | None = None) -> LatencySummary:
        if stage is None:
            return summarize(self.end_to_end_series())
        return summarize(self.stage_series(stage))

    def streaming(self, stage: str = "end_to_end") -> Welford:
        return self._welford[stage]

    def correlation_with_end_to_end(self, stage: str) -> float:
        """Table VI: corr(stage latency, end-to-end latency)."""
        return pearson(self.stage_series(stage), self.end_to_end_series())

    def breakdown_table(self) -> list[dict]:
        rows = []
        for st in self.stages():
            s = self.summary(st)
            rows.append(
                {
                    "stage": st,
                    "mean": s.mean,
                    "range": s.range,
                    "cv": s.cv,
                    "corr_e2e": self.correlation_with_end_to_end(st),
                }
            )
        return rows


class StageTimer:
    """Context-manager based per-job timer::

        timer = StageTimer()
        with timer.stage("read"):
            x = load()
        with timer.stage("inference"):
            out = step(x)
            fence(out)     # the device's work counts in this stage
        rec.add(timer.finish())
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter) -> None:
        self._clock = clock
        self._record = StageRecord()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            self._record.stages[name] = (
                self._record.stages.get(name, 0.0) + self._clock() - t0
            )

    def note(self, key: str, value: float) -> None:
        self._record.meta[key] = float(value)

    def finish(self) -> StageRecord:
        rec, self._record = self._record, StageRecord()
        return rec


@contextlib.contextmanager
def timed_stage(timer: StageTimer, name: str, *values: Any) -> Iterator[None]:
    """Like ``timer.stage`` but fences on the devices of ``values`` before
    closing the interval, so asynchronous work does not leak into the
    next stage."""
    with timer.stage(name):
        yield
        fence(values)
