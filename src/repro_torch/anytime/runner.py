"""The anytime frame loop: per frame, ask the controller for a rung that
fits the residual deadline, run that rung's (already-built) pipeline
through the paper's stage-timed harness, score quality against ground
truth, and feed the measurement back into the cost model.

``budget_fn`` makes contention injectable: a scheduler (or test) can
shrink the residual budget for a window of frames — e.g. a co-resident
task stealing host time — and the report shows the controller degrading
through it and recovering after.

The port of ``repro/anytime/runner.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Mapping, Optional

import numpy as np
import torch

from ..core.timing import TimelineRecorder
from ..perception.data import Scene, SceneConfig, generate_scene
from ..perception.pipelines import BuiltPipeline, run_frame

from .controller import ContractController, FixedController
from .cost import SceneFeatures
from .ladder import Ladder, Rung, frame_quality

__all__ = [
    "FrameResult",
    "AnytimeReport",
    "build_rungs",
    "run_anytime",
    "trace_budget_fn",
    "trace_scene_fn",
]


@dataclasses.dataclass(frozen=True)
class FrameResult:
    index: int
    rung: str
    budget_s: float
    latency_s: float
    miss: bool
    quality: Optional[float]        # None when the frame has no GT objects
    num_proposals: float
    fits: bool                      # controller believed the budget was met


@dataclasses.dataclass
class AnytimeReport:
    frames: list[FrameResult]
    recorder: TimelineRecorder
    switches: int

    @property
    def miss_rate(self) -> float:
        if not self.frames:
            return math.nan
        return float(np.mean([f.miss for f in self.frames]))

    @property
    def mean_quality(self) -> float:
        qs = [f.quality for f in self.frames if f.quality is not None]
        return float(np.mean(qs)) if qs else math.nan

    @property
    def p99_latency(self) -> float:
        if not self.frames:
            return math.nan
        return float(np.percentile([f.latency_s for f in self.frames], 99))

    @property
    def mean_latency(self) -> float:
        if not self.frames:
            return math.nan
        return float(np.mean([f.latency_s for f in self.frames]))

    def rung_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for f in self.frames:
            counts[f.rung] = counts.get(f.rung, 0) + 1
        return counts

    def rung_trace(self) -> list[str]:
        return [f.rung for f in self.frames]


def build_rungs(rungs: Iterable[Rung], cfg: SceneConfig,
                generator: Optional[torch.Generator] = None,
                device: str | torch.device = "cuda",
                params: Optional[Mapping[str, Mapping[str, Any]]] = None,
                ) -> dict[str, BuiltPipeline]:
    """Build and warm every rung once (one frame each), so no frame in the
    timed loop pays the first-call outlier.  Accepts a ``Ladder`` or a plain
    rung list (calibration can therefore share the built pipelines).
    ``params`` maps a pipeline registry name to the parameter tree its rungs
    take in place of weights drawn from ``generator``."""
    built = {r.name: r.build(generator, device,
                             None if params is None else params.get(r.pipeline))
             for r in rungs}
    scene0 = generate_scene(cfg, 0)
    for bp in built.values():
        run_frame(bp, scene0)
    return built


def trace_budget_fn(trace) -> Callable[[int], float]:
    """Adapt a ``repro.scenarios.ScenarioTrace`` contention/budget profile
    into ``run_anytime``'s per-frame ``budget_fn``: frame ``i`` gets the
    trace's interpolated budget at tick ``i`` (past the trace's end, the
    final segment's endpoint holds)."""
    return lambda i: trace.budget_at_tick(i)


def trace_scene_fn(trace, stream_id: str) -> Callable[[int], Scene]:
    """Adapt one trace stream's segment-parameterized conditions into
    ``run_anytime``'s per-frame ``scene_fn`` (single-stream episodes: the
    scenario mix, rain ramp and per-segment seeds of ``stream_id`` without
    the multi-stream replayer).  Only the per-tick configs are
    materialized — scenes render lazily per call (a rendered frame is
    ~0.4 MB; pinning a long episode's worth would cost O(ticks) images)."""
    cfgs = list(trace.stream_configs(stream_id))

    def fn(i: int) -> Scene:
        cfg, idx = cfgs[min(i, len(cfgs) - 1)]
        return generate_scene(cfg, idx)

    return fn


def run_anytime(
    ladder: Ladder,
    cfg: SceneConfig,
    budget_s: float,
    controller: Optional[ContractController | FixedController] = None,
    n: int = 40,
    generator: Optional[torch.Generator] = None,
    budget_fn: Optional[Callable[[int], float]] = None,
    built: Optional[dict[str, BuiltPipeline]] = None,
    scene_fn: Optional[Callable[[int], Scene]] = None,
    device: str | torch.device = "cuda",
    params: Optional[Mapping[str, Mapping[str, Any]]] = None,
) -> AnytimeReport:
    """Run ``n`` frames under a per-frame residual deadline.

    ``controller`` defaults to a fresh ``ContractController``; pass a
    ``FixedController`` for the static A/B baseline.  ``budget_fn(i)``
    overrides the constant budget per frame (contention injection).
    ``built`` reuses built rungs across runs so A/B arms share one
    warm-up; without it the rungs are built on ``device`` from
    ``generator`` or ``params``, as ``build_rungs`` builds them.
    ``scene_fn(i)`` overrides the stationary ``cfg``
    stream with arbitrary per-frame scenes (time-varying episodes — see
    ``trace_scene_fn``/``trace_budget_fn``).
    """
    if built is None:
        built = build_rungs(ladder, cfg, generator, device, params)
    ctl = controller if controller is not None else ContractController(ladder)
    rec = TimelineRecorder()
    frames: list[FrameResult] = []
    prev_proposals: Optional[float] = None
    for i in range(n):
        scene = scene_fn(i) if scene_fn is not None else generate_scene(cfg, i + 1)
        budget = budget_fn(i) if budget_fn is not None else budget_s
        feats = SceneFeatures(
            proposals_prev=prev_proposals,
            rain_mm_per_hour=scene.rain,
            scenario=scene.scenario,
        )
        sel = ctl.select(budget, feats)
        record, out = run_frame(built[sel.rung.name], scene)
        record.meta["rung_index"] = float(sel.index)
        rec.add(record)
        ctl.observe(sel.rung.name, record, feats)

        lat = record.end_to_end
        frames.append(FrameResult(
            index=i, rung=sel.rung.name, budget_s=budget, latency_s=lat,
            miss=lat > budget, quality=frame_quality(scene, out),
            num_proposals=out.num_proposals, fits=sel.fits,
        ))
        prev_proposals = out.num_proposals
    return AnytimeReport(frames=frames, recorder=rec, switches=ctl.switches)
