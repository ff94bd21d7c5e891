"""Per-frame, per-rung latency cost model.

The paper's Insights 1/3: host post-processing time is driven by
observable, temporally-coherent scene quantities (proposal counts, scene
density, rain).  So each rung's latency is predicted per stage with the
estimator that fits the stage's behaviour:

* read / pre-processing / inference — near-stationary per rung: tracked
  with the online ``KalmanPredictor`` (ALERT-style), which also adapts
  when contention drifts the whole pipeline.
* post-processing — data-dependent: ``FeaturePredictor`` regresses post
  time on the *composite scene feature* (previous frame's proposal count,
  or a scenario-density × rain prior before any frame has run).

Predictions are Gaussians combined across stages (independent-stage
variance sum), exposed as ``Prediction`` so the controller reasons about
p99 quantiles, not just means.  Before a rung has been observed online,
the calibrated ``stage_means`` serve as the prior (a configurable prior
CV supplies the spread).

Batched serving adds a fourth estimator: per-(rung, batch-size) latency
(``SceneFeatures.batch_size``), a regression of shared batched-step time
on the number of co-resident streams — see ``RungCostModel`` for the
semantics and priors.

A copy of the reference's ``repro/anytime/cost.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ..core.predictor import FeaturePredictor, KalmanPredictor, Prediction
from ..core.timing import StageRecord
from ..perception.data import SCENARIOS

from .ladder import Ladder, Rung

__all__ = ["SceneFeatures", "RungCostModel", "LadderCostModel",
           "cold_start_prior_table"]

# bright 8×8 cells one object contributes to the proposal map, roughly
_CELLS_PER_OBJECT = 5.0


@dataclasses.dataclass(frozen=True)
class SceneFeatures:
    """Observable pre-execution signals for one frame.

    ``batch_size`` is the (rung, batch-size) feature for batched serving
    (``repro.batched``): the number of co-resident streams expected to
    share this frame's batched device step.  With ``batched`` unset, a
    batch size of 1 (the default) keeps the cost model exactly as in
    single-stream serving; above 1 the prediction switches to a per-rung
    regression of *batched-step* latency on batch size, so the
    controller's residual-deadline decision accounts for batching delay.
    ``batched=True`` forces the batched route even at bucket size 1 — a
    singleton bucket still pays a full capacity-wide padded step, which
    the serial stage model would badly under-estimate (and which must
    never pollute the serial per-stage predictors).  Like
    ``proposals_prev`` these are pre-execution estimates — the
    rung-bucket scheduler feeds last tick's bucket size, relying on the
    same temporal coherence.

    ``pipeline_depth`` is the pipelined-latency mode: the batched engine
    at depth *d* overlaps upload/compute/post across ticks, so its
    per-tick host cost is a *throughput* figure while a frame's
    completion latency spans the whole pipe — a result drains ``d-1``
    ticks after its scene was submitted.  Trained batched predictions
    come from a regression on observed completion latencies
    (``frame_latency_s`` on pipelined records) and need no rescaling;
    before any batched observation exists, the cold-start prior scales
    the serial bound by ``pipeline_depth`` so an untrained controller
    never under-estimates pipe residence.  Depth 1 (the default, and the
    synchronous engine) is unchanged.
    """

    proposals_prev: Optional[float] = None   # previous frame's proposal count
    rain_mm_per_hour: float = 0.0
    scenario: str = "city"
    batch_size: float = 1.0                  # expected co-batch size (>= 1)
    batched: Optional[bool] = None           # force the batched cost route
    pipeline_depth: float = 1.0              # executor pipeline depth (>= 1)

    @property
    def is_batched(self) -> bool:
        if self.batched is not None:
            return self.batched
        return self.batch_size > 1.0

    def composite(self) -> float:
        """Scalar feature for the post-processing regression: the previous
        frame's proposal count when available (scenes are temporally
        coherent), else a scenario-density prior attenuated by rain
        (Table IV: rain occludes proposals)."""
        if self.proposals_prev is not None:
            return float(self.proposals_prev)
        mu_obj = SCENARIOS.get(self.scenario, (6.0, 3.0))[0]
        atten = max(1.0 - self.rain_mm_per_hour / 400.0, 0.25)
        return _CELLS_PER_OBJECT * mu_obj * atten


class RungCostModel:
    """Per-stage online predictors for one rung.

    The Kalman noise parameters are scaled for millisecond stage
    latencies (the predictor defaults assume ~100ms signals; a 10ms
    measurement-noise floor would drown a 3ms stage and make every tail
    estimate worst-case).

    **The (rung, batch-size) feature.**  Batched serving
    (``repro.batched``) runs many streams through one shared device step,
    whose latency is a function of the *bucket size*, not of any single
    frame.  Observations with ``feats.is_batched`` therefore train a
    separate ``FeaturePredictor`` regressing whole-step latency on batch
    size (near-affine: a fixed-capacity padded batch has a large constant
    term plus a small per-active-slot term), and batched predictions
    come from that regression.  Before any batched
    observation exists, the prior is the pessimistic serial bound —
    single-frame latency × batch size — so an untrained controller never
    *under*-estimates batching delay.  Single-frame behaviour
    (``batch_size == 1``) is untouched.
    """

    def __init__(
        self,
        rung: Rung,
        prior_cv: float = 0.25,
        kalman_q: float = 1e-9,
        kalman_r: float = 1e-7,
    ) -> None:
        if not rung.stage_means:
            # a zero prior would make every budget "fit" — fail loudly
            raise ValueError(
                f"rung {rung.name!r} is uncalibrated (no stage_means); "
                "run anytime.calibrate() before building a cost model"
            )
        self.rung = rung
        self.prior_cv = prior_cv
        self._host = KalmanPredictor(q=kalman_q, r=kalman_r)   # read + pre
        self._infer = KalmanPredictor(q=kalman_q, r=kalman_r)
        self._post = FeaturePredictor()
        self._batch_step = FeaturePredictor()   # batched e2e vs batch size
        self.observations = 0
        self.batched_observations = 0

    def observe(self, record: StageRecord, feats: SceneFeatures) -> None:
        """Feed one measured frame.  ``feats`` must be the features the
        caller *predicted with* for this frame, so the regression learns
        the deployable mapping (prev-frame proposals → this post time).
        Batched-step records (``feats.is_batched``) train only the
        batch-size regression: a shared padded step is not an observation
        of single-frame stage behaviour, whatever its bucket size.

        Pipelined records carry ``frame_latency_s`` (submit→drain
        completion time) and the regression trains on THAT: their
        ``end_to_end`` is only the overlapped host residual — near zero
        exactly when the pipeline works best — and a model trained on it
        would bless rungs whose completion latency busts the budget."""
        if feats.is_batched:
            lat = record.meta.get("frame_latency_s", record.end_to_end)
            self._batch_step.observe(lat, feats.batch_size)
            self.batched_observations += 1
            return
        st = record.stages
        self._host.observe(st.get("read", 0.0) + st.get("pre_processing", 0.0))
        self._infer.observe(st.get("inference", 0.0))
        self._post.observe(st.get("post_processing", 0.0), feats.composite())
        self.observations += 1

    def _stage_prior(self, *stages: str) -> Prediction:
        mean = sum(self.rung.stage_means.get(s, 0.0) for s in stages)
        if math.isnan(mean):
            mean = 0.0
        return Prediction(mean, self.prior_cv * mean)

    def _or_prior(self, p: Prediction, *stages: str) -> Prediction:
        if p.mean != p.mean:          # NaN: predictor has no data yet
            return self._stage_prior(*stages)
        # a freshly-seeded predictor reports ~zero spread; keep at least
        # the prior's uncertainty until residuals accumulate
        floor = self.prior_cv * max(p.mean, 0.0)
        if self.observations < 5:
            prior_std = self._stage_prior(*stages).std
            floor = max(floor, prior_std)
        return Prediction(p.mean, max(p.std, floor))

    def _predict_single(self, feats: SceneFeatures) -> Prediction:
        host = self._or_prior(self._host.predict(), "read", "pre_processing")
        infer = self._or_prior(self._infer.predict(), "inference")
        post = self._or_prior(self._post.predict(feats.composite()), "post_processing")
        mean = host.mean + infer.mean + post.mean
        std = math.sqrt(host.std ** 2 + infer.std ** 2 + post.std ** 2)
        return Prediction(mean, std)

    def predict(self, feats: SceneFeatures) -> Prediction:
        if not feats.is_batched:
            return self._predict_single(feats)
        if self.batched_observations == 0:
            # serial pessimistic prior: no batching gain assumed until the
            # regression has seen a real batched step.  Pipelined, a frame
            # additionally resides in the pipe for ~depth ticks, so the
            # unobserved completion-latency prior scales with depth.
            depth = max(feats.pipeline_depth, 1.0)
            single = self._predict_single(feats)
            mean = single.mean * feats.batch_size * depth
            return Prediction(mean, max(single.std * feats.batch_size * depth,
                                        self.prior_cv * mean))
        # trained: the regression already learned completion latency
        # (frame_latency_s on pipelined records, tick e2e on sync ones),
        # so no depth rescaling — multiplying observed completions by
        # depth again would double-count pipe residence
        p = self._batch_step.predict(feats.batch_size)
        floor = self.prior_cv * max(p.mean, 0.0)
        return Prediction(p.mean, max(p.std, floor))


def cold_start_prior_table(rungs, batch_sizes, depth: float = 1.0,
                           prior_cv: float = 0.25) -> dict:
    """Untrained per-(rung, batch-size) latency priors, in seconds.

    For every calibrated rung × batch size, the cold-start batched
    prediction (``RungCostModel.predict`` with zero batched
    observations): single-frame calibrated mean × batch size × depth.
    The static certifier (``repro.analysis.cert``) commits these next to
    its roofline floors — the drift gate compares ``prior / floor`` over
    time, so a model change that shifts static FLOPs without a matching
    recalibration is caught before any frame runs.  Raises on an
    uncalibrated rung, same as ``RungCostModel``.
    """
    table = {}
    for rung in rungs:
        model = RungCostModel(rung, prior_cv=prior_cv)
        for b in batch_sizes:
            feats = SceneFeatures(batch_size=float(b), batched=True,
                                  pipeline_depth=depth)
            table[(rung.name, int(b))] = model.predict(feats).mean
    return table


class LadderCostModel:
    """One ``RungCostModel`` per rung, addressed by rung name."""

    def __init__(self, ladder: Ladder, prior_cv: float = 0.25) -> None:
        self.ladder = ladder
        self._models = {r.name: RungCostModel(r, prior_cv) for r in ladder}

    def model(self, rung_name: str) -> RungCostModel:
        return self._models[rung_name]

    def observe(self, rung_name: str, record: StageRecord, feats: SceneFeatures) -> None:
        self._models[rung_name].observe(record, feats)

    def predict(self, rung_name: str, feats: SceneFeatures) -> Prediction:
        return self._models[rung_name].predict(feats)

    def quantile(self, rung_name: str, feats: SceneFeatures, q: float) -> float:
        return self.predict(rung_name, feats).quantile(q)
