"""Deadline-aware admission control (paper Insight 4, applied to serving);
copied from the reference's ``repro/runtime/admission.py`` onto the
port's ``core/predictor.py``.

The paper's scheduler analysis shows that deadline mechanisms built on the
*worst observed* latency waste reserved budget, while tight budgets throttle
constantly.  The serving-side fix is to decide *before* seating a stream
whether its SLO is achievable under the contention it would join: predict
the engine step latency at the prospective occupancy (streams sharing one
accelerator batch), and admit only when the predicted tail fits the
tenant's deadline.

The latency model reuses ``core.predictor.FeaturePredictor`` — an online
ridge-regularized linear fit of step latency against the number of
co-resident streams, exactly the observable-feature prediction the paper
argues for (Insight 1/3: predict per-job latency instead of budgeting for
the worst case).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ..core.predictor import FeaturePredictor, Prediction

from .queue import StreamRequest

__all__ = ["AdmissionDecision", "AdmissionController", "AnytimeAdmission", "AlwaysAdmit"]

ADMIT = "admit"
DEFER = "defer"
SHED = "shed"


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    action: str                  # admit | defer | shed
    predicted: Optional[Prediction]
    reason: str
    # set when the admitted stream differs from the one asked about (the
    # anytime path admits a degraded-SLO replacement); the engine must
    # seat THIS request, not the original
    request: Optional[StreamRequest] = None


class AdmissionController:
    """Predict step latency at the prospective occupancy; gate admission.

    * ``admit``  — predicted ``quantile(confidence)`` step latency at
      occupancy ``n_active + 1`` fits the tenant's per-token SLO.
    * ``defer``  — the SLO would be breached *now*, but would be met at the
      lowest occupancy ever admitted (1): wait for slots to drain.
    * ``shed``   — the SLO is unachievable even alone (predicted solo
      latency breaches it) or the request has waited past ``max_wait_s``:
      reject at the door so seated tenants keep their deadlines.

    Best-effort streams (``deadline_s is None``) are always admitted when a
    slot is free — shedding only ever protects an explicit SLO.
    """

    def __init__(
        self,
        confidence: float = 0.95,
        max_wait_s: float = math.inf,
        min_observations: int = 3,
    ) -> None:
        self.model = FeaturePredictor()
        self.confidence = confidence
        self.max_wait_s = max_wait_s
        self.min_observations = min_observations
        self._n_obs = 0
        self.admitted = 0
        self.deferred = 0          # unique requests deferred at least once
        self.shed = 0
        # in-flight deferred requests by admission token.  Object identity
        # (``id(req)``) is NOT safe here: once a deferred request is
        # garbage-collected its id can be recycled by a brand-new request,
        # which would then silently skip its own deferred count.  The
        # monotone ``StreamRequest.admission_token`` is never reused.
        # Entries are removed on the final admit/shed decision, bounding
        # the set.
        self._deferred_inflight: set[int] = set()

    # ---------------- latency model ----------------
    def observe_step(self, n_active: int, latency: float) -> None:
        """Feed one engine step: occupancy → measured step latency."""
        self.model.observe(latency, float(n_active))
        self._n_obs += 1

    def predict(self, n_active: int) -> Prediction:
        return self.model.predict(float(n_active))

    def _tail(self, n_active: int) -> float:
        p = self.predict(n_active)
        if p.mean != p.mean:          # NaN: no observations yet
            return 0.0
        return p.quantile(self.confidence)

    # ---------------- decision ----------------
    def decide(
        self, req: StreamRequest, n_active: int, now: float, record: bool = True
    ) -> AdmissionDecision:
        """Decide admit/defer/shed.  ``record=False`` makes the call a pure
        probe: no counters or inflight bookkeeping are touched (the anytime
        wrapper probes degraded service levels without polluting stats)."""
        if req.deadline_s is None:
            if record:
                self.admitted += 1
            return AdmissionDecision(ADMIT, None, "best-effort")
        if self._n_obs < self.min_observations:
            # cold start: no basis for prediction — admit and learn
            if record:
                self.admitted += 1
            return AdmissionDecision(ADMIT, None, "cold-start")

        waited = now - req.arrival_s
        pred_joined = self.predict(n_active + 1)
        tail_joined = self._tail(n_active + 1)
        if tail_joined <= req.deadline_s:
            if record:
                self.admitted += 1
                self._deferred_inflight.discard(req.admission_token)
            return AdmissionDecision(
                ADMIT, pred_joined,
                f"p{self.confidence*100:.0f} step {tail_joined*1e3:.2f}ms "
                f"<= SLO {req.deadline_s*1e3:.2f}ms at occupancy {n_active + 1}",
            )
        if waited > self.max_wait_s:
            if record:
                self.shed += 1
                self._deferred_inflight.discard(req.admission_token)
            return AdmissionDecision(
                SHED, pred_joined,
                f"waited {waited:.3f}s > max_wait {self.max_wait_s:.3f}s",
            )
        tail_solo = self._tail(1)
        if tail_solo > req.deadline_s:
            if record:
                self.shed += 1
                self._deferred_inflight.discard(req.admission_token)
            return AdmissionDecision(
                SHED, pred_joined,
                f"SLO {req.deadline_s*1e3:.2f}ms unachievable: solo "
                f"p{self.confidence*100:.0f} step is {tail_solo*1e3:.2f}ms",
            )
        # a head-of-line request is re-decided every drain iteration while
        # it waits: count it once, like admitted/shed per-request counters
        if record and req.admission_token not in self._deferred_inflight:
            self._deferred_inflight.add(req.admission_token)
            self.deferred += 1
        return AdmissionDecision(
            DEFER, pred_joined,
            f"p{self.confidence*100:.0f} step {tail_joined*1e3:.2f}ms "
            f"> SLO {req.deadline_s*1e3:.2f}ms at occupancy {n_active + 1}",
        )


class AnytimeAdmission:
    """Degrade-before-shed decorator over an ``AdmissionController``.

    The anytime subsystem's philosophy applied at the admission boundary:
    when the inner controller would shed an SLO-bearing stream, try the
    stream's declared service ladder (``StreamRequest.degrade_factors``,
    SLO relaxation factors in preference order) and admit the first level
    the inner controller accepts.  Degraded service beats no service; the
    relaxed SLO sticks to the seated tenant so misses are scored against
    the contract actually granted.
    """

    def __init__(self, inner: AdmissionController) -> None:
        self.inner = inner
        self.degraded = 0              # streams rescued from a shed
        self.degrade_log: list[tuple[str, float]] = []   # (tenant, factor)
        # requests counted as deferred via a degraded probe, keyed by the
        # monotone admission token (identity-by-id would alias recycled
        # ids; the token also survives dataclasses.replace, so the
        # degraded clone stays the same logical request)
        self._rescued_defer: set[int] = set()

    # latency model passthrough -------------------------------------------
    def observe_step(self, n_active: int, latency: float) -> None:
        self.inner.observe_step(n_active, latency)

    def predict(self, n_active: int) -> Prediction:
        return self.inner.predict(n_active)

    @property
    def admitted(self) -> int:
        return self.inner.admitted

    @property
    def deferred(self) -> int:
        return self.inner.deferred

    @property
    def shed(self) -> int:
        return self.inner.shed

    # decision -------------------------------------------------------------
    def decide(
        self, req: StreamRequest, n_active: int, now: float
    ) -> AdmissionDecision:
        rid = req.admission_token
        if rid in self._rescued_defer:
            # already counted as deferred through a degraded probe; seed the
            # inner inflight set so a genuine defer doesn't double-count
            self.inner._deferred_inflight.add(rid)
        decision = self.inner.decide(req, n_active, now)
        if (
            decision.action != SHED
            or req.deadline_s is None
            or not req.degrade_factors
        ):
            if decision.action in (ADMIT, SHED):
                self._rescued_defer.discard(rid)
            return decision
        for factor in req.degrade_factors:
            relaxed = dataclasses.replace(
                req, deadline_s=req.deadline_s * factor, degrade_factors=()
            )
            # pure probe: no counter side effects to undo
            retry = self.inner.decide(relaxed, n_active, now, record=False)
            if retry.action == ADMIT:
                # the stream was rescued, not shed — it is one admit
                self.inner.shed -= 1
                self.inner.admitted += 1
                self.degraded += 1
                self.degrade_log.append((req.tenant, factor))
                self._rescued_defer.discard(rid)
                return AdmissionDecision(
                    ADMIT, retry.predicted,
                    f"degraded SLO ×{factor:g} "
                    f"({req.deadline_s * 1e3:.2f}→{relaxed.deadline_s * 1e3:.2f}ms): "
                    f"{retry.reason}",
                    request=relaxed,
                )
            if retry.action == DEFER:
                # admissible at a degraded SLO once slots drain: wait rather
                # than shed; count the defer once per request across the
                # head-of-line retries
                self.inner.shed -= 1
                if rid not in self._rescued_defer:
                    self._rescued_defer.add(rid)
                    self.inner.deferred += 1
                return AdmissionDecision(
                    DEFER, retry.predicted,
                    f"deferred at degraded SLO ×{factor:g}: {retry.reason}",
                )
        self._rescued_defer.discard(rid)
        return decision


class AlwaysAdmit:
    """Null controller: every request is seated as soon as a slot frees.
    The benchmark's no-admission-control baseline."""

    def __init__(self) -> None:
        self.admitted = 0
        self.deferred = 0
        self.shed = 0

    def observe_step(self, n_active: int, latency: float) -> None:
        pass

    def predict(self, n_active: int) -> Prediction:
        return Prediction(float("nan"), float("nan"))

    def decide(
        self, req: StreamRequest, n_active: int, now: float
    ) -> AdmissionDecision:
        self.admitted += 1
        return AdmissionDecision(ADMIT, None, "always-admit")
