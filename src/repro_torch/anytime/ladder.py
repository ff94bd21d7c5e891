"""The fidelity ladder: an ordered set of perception pipeline rungs.

Each rung names a registered pipeline variant (``perception.pipelines``
registry) at an input scale λ, and carries two calibrated properties:

* ``quality``      — detection quality against the synthetic scenes'
  ground truth (``Scene.boxes``): greedy IoU matching, scored as the mean
  of recall and matched IoU (both in [0, 1]).
* ``stage_means``  — per-stage mean latency from a calibration run, the
  cost model's cold-start prior and the scheduling simulator's per-rung
  stage parameters.

``calibrate`` measures both on real frames and returns a ``Ladder``
sorted best-quality-first, so rung order is an empirical property of the
pipelines, never an assertion.

The port of ``repro/anytime/ladder.py``.  Where the reference takes a JAX
key, the entry points here take a CPU ``torch.Generator``, ``device``
(default ``"cuda"``) and ``params``, a mapping from pipeline registry name
to a reference parameter tree of NumPy arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from ..perception.data import Scene, SceneConfig
from ..perception.pipelines import FrameOutput, build_pipeline, run_pipeline
from ..sched.simulator import StageSpec

__all__ = [
    "Rung",
    "Ladder",
    "default_rungs",
    "calibrate",
    "frame_quality",
    "rung_stage_specs",
]

STAGES = ("read", "pre_processing", "inference", "post_processing")


@dataclasses.dataclass
class Rung:
    """One fidelity level: a registered pipeline at an input scale."""

    name: str                     # display name, unique within a ladder
    pipeline: str                 # perception.pipelines registry key
    scale: float = 1.0            # input scale λ (pad=False: smaller input)
    quality: float = math.nan     # calibrated vs Scene.boxes
    stage_means: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def e2e_mean(self) -> float:
        return sum(self.stage_means.values()) if self.stage_means else math.nan

    def build(self, generator: Optional[torch.Generator] = None,
              device: str | torch.device = "cuda", params: Optional[Mapping[str, Any]] = None):
        return build_pipeline(self.pipeline, scale=self.scale, generator=generator, pad=False,
                              device=device, params=params)


@dataclasses.dataclass
class Ladder:
    """Rungs ordered best-quality-first (index 0 = highest fidelity)."""

    rungs: list[Rung]

    def __post_init__(self) -> None:
        if not self.rungs:
            raise ValueError("a ladder needs at least one rung")
        names = [r.name for r in self.rungs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rung names: {names}")

    def __len__(self) -> int:
        return len(self.rungs)

    def __iter__(self) -> Iterator[Rung]:
        return iter(self.rungs)

    def __getitem__(self, i: int) -> Rung:
        return self.rungs[i]

    def index(self, name: str) -> int:
        for i, r in enumerate(self.rungs):
            if r.name == name:
                return i
        raise KeyError(f"no rung named {name!r}: {[r.name for r in self.rungs]}")

    @property
    def top(self) -> Rung:
        return self.rungs[0]

    @property
    def floor(self) -> Rung:
        return self.rungs[-1]

    def table(self) -> list[dict]:
        rows = []
        for r in self.rungs:
            row = {"rung": r.name, "pipeline": r.pipeline, "scale": r.scale,
                   "quality": r.quality, "e2e_ms": r.e2e_mean * 1e3}
            for st in STAGES:
                if st in r.stage_means:
                    row[f"{st}_ms"] = r.stage_means[st] * 1e3
            rows.append(row)
        return rows


def default_rungs() -> list[Rung]:
    """The detection ladder: two-stage (dynamic post, best quality) down
    through λ-scaled one-stage (static post) to the truncated-backbone
    early exit — every fidelity axis the paper's variance analysis names."""
    return [
        Rung("two_stage", "two_stage", 1.0),
        Rung("one_stage", "one_stage", 1.0),
        Rung("one_stage@0.75", "one_stage", 0.75),
        Rung("one_stage@0.5", "one_stage", 0.5),
        Rung("early_exit@0.5", "early_exit", 0.5),
    ]


# ---------------------------------------------------------------------------
# quality scoring
# ---------------------------------------------------------------------------

def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if not len(a) or not len(b):
        return np.zeros((len(a), len(b)))
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    iy0 = np.maximum(a[:, 0][:, None], b[:, 0][None])
    ix0 = np.maximum(a[:, 1][:, None], b[:, 1][None])
    iy1 = np.minimum(a[:, 2][:, None], b[:, 2][None])
    ix1 = np.minimum(a[:, 3][:, None], b[:, 3][None])
    inter = np.maximum(iy1 - iy0, 0) * np.maximum(ix1 - ix0, 0)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def frame_quality(scene: Scene, out: FrameOutput, iou_thr: float = 0.1) -> Optional[float]:
    """0.5·recall + 0.5·mean-matched-IoU against ``Scene.boxes``; None when
    the frame has no ground-truth objects (nothing to score)."""
    gt = scene.boxes
    if not len(gt):
        return None
    best = _iou_matrix(gt, out.boxes)
    best = best.max(axis=1) if best.size else np.zeros(len(gt))
    matched = best >= iou_thr
    recall = float(matched.mean())
    miou = float(best[matched].mean()) if matched.any() else 0.0
    return 0.5 * recall + 0.5 * miou


def calibrate(
    rungs: Sequence[Rung],
    cfg: SceneConfig,
    n: int = 12,
    generator: Optional[torch.Generator] = None,
    built=None,
    device: str | torch.device = "cuda",
    params: Optional[Mapping[str, Mapping[str, Any]]] = None,
) -> Ladder:
    """Run every rung over ``n`` frames, fill in measured quality and
    per-stage latency means, and return a Ladder sorted by quality.

    ``built`` (rung name → ``BuiltPipeline``, e.g. from
    ``runner.build_rungs``) reuses already-built pipelines so
    calibration and the anytime loop share one warm-up; without it each
    rung is built on ``device`` from ``generator`` or, where ``params``
    (pipeline name → parameter tree) holds its pipeline, from those."""
    measured = []
    for rung in rungs:
        rec, outs = run_pipeline(
            rung.pipeline, cfg, n=n, scale=rung.scale, generator=generator,
            collect=True, pad=False,
            built=None if built is None else built.get(rung.name),
            device=device, params=None if params is None else params.get(rung.pipeline),
        )
        qs = [q for sc, o in outs if (q := frame_quality(sc, o)) is not None]
        stage_means = {st: float(rec.stage_series(st).mean()) for st in rec.stages()}
        measured.append(dataclasses.replace(
            rung,
            quality=float(np.mean(qs)) if qs else 0.0,
            stage_means=stage_means,
        ))
    measured.sort(key=lambda r: r.quality, reverse=True)
    return Ladder(measured)


def rung_stage_specs(rung: Rung, jitter: float = 0.1) -> tuple[StageSpec, ...]:
    """Map a calibrated rung onto the scheduling simulator's stage chain:
    host stages on CPU, inference on the accelerator — so policy × fidelity
    interactions are simulable (``TaskSpec.rungs``)."""
    if not rung.stage_means:
        raise ValueError(f"rung {rung.name!r} is uncalibrated (no stage_means)")
    host_pre = rung.stage_means.get("read", 0.0) + rung.stage_means.get("pre_processing", 0.0)
    return (
        StageSpec("pre", "cpu", max(host_pre, 1e-6), jitter),
        StageSpec("infer", "accel", max(rung.stage_means.get("inference", 0.0), 1e-6), jitter),
        StageSpec("post", "cpu", max(rung.stage_means.get("post_processing", 0.0), 1e-6), jitter),
    )
