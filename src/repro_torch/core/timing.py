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
from typing import Any, Callable, Iterator, Mapping, Sequence

import numpy as np
import torch

from .stats import LatencySummary, Welford, pearson, summarize

__all__ = [
    "StageRecord",
    "TimelineRecorder",
    "StageTimer",
    "timed_stage",
    "instrument",
    "run_pipeline",
    "fence",
    "to_host",
    "STAGE_AXES",
]

# Canonical stage names from the paper's Fig. 3 timeline.
READ = "read"
PRE = "pre_processing"
INFER = "inference"
POST = "post_processing"
CANONICAL_STAGES = (READ, PRE, INFER, POST)

# Default variation-axis tag per canonical stage (paper Table I): read is
# I/O-bound, pre/post scale with input content, inference is the model.
# Unknown stage names fall back to the residual end_to_end axis.
STAGE_AXES = {
    READ: "io",
    PRE: "data",
    INFER: "model",
    POST: "data",
    "upload": "io",
    "step": "model",
    "post": "data",
}


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


def _map_tensors(fn: Callable[[torch.Tensor], Any], values: Any) -> Any:
    if isinstance(values, torch.Tensor):
        return fn(values)
    if isinstance(values, dict):
        return {k: _map_tensors(fn, v) for k, v in values.items()}
    if isinstance(values, (list, tuple)):
        return type(values)(_map_tensors(fn, v) for v in values)
    return values


def to_host(tree: Any) -> Any:
    """One readback of a whole output tree: every CUDA leaf is copied into
    pinned host memory without blocking (a non-blocking copy to the CPU
    allocates from the pinned pool), then each device's current stream is
    synchronised once, so the tree costs one wait however many leaves it
    has.  Returns the same nesting (tuples, lists, dicts) with NumPy arrays
    for the tensors; a CPU tensor is viewed, not copied."""
    host = _map_tensors(lambda t: t.to("cpu", non_blocking=True), tree)
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()
    return _map_tensors(lambda t: t.numpy(), host)


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
    questions: per-stage summaries, variance attribution inputs, and
    correlation of any metadata series with end-to-end latency.

    When constructed with ``metrics=`` (a ``repro_torch.obs.MetricsHub``,
    duck-typed so core stays obs-free), the recorder is a thin adapter:
    every added record is also forwarded to the hub keyed by this
    recorder's stream/rung tags plus the record's ``batch_size`` meta, so
    legacy recorders and the span tracer share one aggregation path."""

    def __init__(self, metrics: Any = None, stream: str = "", rung: str = "") -> None:
        self.records: list[StageRecord] = []
        self._welford: dict[str, Welford] = defaultdict(Welford)
        self._metrics = metrics
        self._stream = stream
        self._rung = rung

    def add(self, record: StageRecord) -> None:
        self.records.append(record)
        for k, v in record.stages.items():
            self._welford[k].update(v)
        self._welford["end_to_end"].update(record.end_to_end)
        if self._metrics is not None:
            bs = int(record.meta.get("batch_size", 0))
            for k, v in record.stages.items():
                self._metrics.observe(self._stream, k, v, rung=self._rung, batch_size=bs)
            self._metrics.observe(self._stream, "end_to_end", record.end_to_end,
                                  rung=self._rung, batch_size=bs)

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

    def correlation_meta(self, key: str, stage: str = POST) -> float:
        """Fig. 5: corr(#detected objects / proposals, post-processing)."""
        return pearson(self.meta_series(key), self.stage_series(stage))

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

    def dominant_stage(self) -> str:
        """The paper's inference-dominated vs post-processing-dominated
        classification: the stage whose latency correlates most with
        end-to-end latency (Table VI argmax)."""
        table = self.breakdown_table()
        if not table:
            raise ValueError("no records")
        return max(table, key=lambda r: r["corr_e2e"])["stage"]


class StageTimer:
    """Context-manager based per-job timer::

        timer = StageTimer()
        with timer.stage("read"):
            x = load()
        with timer.stage("inference"):
            out = step(x)
            fence(out)     # the device's work counts in this stage
        rec.add(timer.finish())

    With ``tracer=`` (a ``repro_torch.obs.SpanTracer``, duck-typed) every
    closed interval is also forwarded as a span carrying ``tags``
    (stream/tick/rung/batch_size/track) and the stage's default axis, so
    stage timing lands on the unified timeline without a second clock
    read: there is exactly one recording path.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter, tracer: Any = None,
                 tags: Mapping[str, Any] | None = None) -> None:
        self._clock = clock
        self._record = StageRecord()
        self._tracer = tracer
        self._tags = dict(tags or {})

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            t1 = self._clock()
            self._record.stages[name] = self._record.stages.get(name, 0.0) + t1 - t0
            if self._tracer is not None:
                self._tracer.record(name, t0, t1, axis=STAGE_AXES.get(name, "end_to_end"),
                                    **self._tags)

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


def instrument(fn: Callable[..., Any], name: str, timer: StageTimer) -> Callable[..., Any]:
    """Wrap ``fn`` so every call is recorded as stage ``name`` with a fence
    on its outputs."""

    def wrapped(*args, **kwargs):
        with timer.stage(name):
            out = fn(*args, **kwargs)
            fence(out)
        return out

    wrapped.__name__ = f"timed_{name}"
    return wrapped


def run_pipeline(
    stages: Sequence[tuple[str, Callable[[Any], Any]]],
    inputs: Iterator[Any],
    recorder: TimelineRecorder,
    meta_fn: Callable[[Any], Mapping[str, float]] | None = None,
    warmup: int = 1,
) -> list[Any]:
    """Drive a (name, fn) pipeline over an input stream recording the full
    per-stage timeline of every job — the paper's profiling harness.  Each
    stage ends in a fence on its output.

    ``warmup`` jobs are executed but not recorded (lazy CUDA and cuDNN
    set-up on the first call would otherwise appear as a giant outlier;
    the paper similarly discards cold-start frames).
    """
    outputs: list[Any] = []
    for i, item in enumerate(inputs):
        timer = StageTimer()
        value = item
        for name, fn in stages:
            with timer.stage(name):
                value = fn(value)
                fence(value)
        if meta_fn is not None:
            for k, v in meta_fn(value).items():
                timer.note(k, v)
        rec = timer.finish()
        if i >= warmup:
            recorder.add(rec)
        outputs.append(value)
    return outputs
