"""The contract controller: pick the best rung that fits the residual
deadline budget, with hysteresis so fidelity doesn't thrash.

Given a frame's residual deadline (whatever ``core.deadline`` policy or
scheduler produced it) and the frame's observable features, the
controller asks the cost model for each rung's ``quantile(q)`` latency —
tail-aware, not mean-aware — and selects the highest-quality rung that
fits.  Two asymmetries implement the contract:

* **degrade immediately** — if the current rung's tail no longer fits,
  drop as far as needed this frame; a missed deadline is the failure the
  subsystem exists to prevent.
* **upgrade reluctantly** — climbing back up requires (a) the higher
  rung's tail to fit the budget with ``upgrade_headroom`` to spare and
  (b) ``hold_frames`` frames since the last switch.  Transient headroom
  therefore doesn't bounce fidelity (hysteresis).

When even the floor rung doesn't fit, the controller still returns the
floor with ``fits=False`` — callers decide whether to shed (the runtime
attempts degradation before admission-shedding, same philosophy).

A copy of the reference's ``repro/anytime/controller.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.predictor import Prediction
from ..core.timing import StageRecord

from .cost import LadderCostModel, SceneFeatures
from .ladder import Ladder, Rung

__all__ = ["ControllerConfig", "Selection", "ContractController", "FixedController"]


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    quantile: float = 0.95        # tail the contract is written against
    upgrade_headroom: float = 1.25  # budget must cover tail × this to climb
    hold_frames: int = 3          # min frames between upward switches
    # Pipelined serving (repro.batched.executor): the engine's pipeline
    # depth.  A frame completes depth-1 ticks after submission, so the
    # cost model scales batched tail estimates by this — throughput goes
    # up under the pipeline, but the per-frame latency the deadline
    # contract is written against is one tick stale per depth level.
    # Stamped into SceneFeatures at select() when the caller leaves the
    # feature at its default.
    pipeline_depth: float = 1.0

    def __post_init__(self) -> None:
        if not 0.5 <= self.quantile < 1.0:
            raise ValueError(f"quantile must be in [0.5, 1) (got {self.quantile})")
        if self.upgrade_headroom < 1.0:
            raise ValueError("upgrade_headroom must be >= 1")
        if self.hold_frames < 0:
            raise ValueError("hold_frames must be >= 0")
        if self.pipeline_depth < 1.0:
            raise ValueError("pipeline_depth must be >= 1")


@dataclasses.dataclass(frozen=True)
class Selection:
    rung: Rung
    index: int                    # ladder index (0 = best quality)
    predicted: Prediction
    fits: bool                    # predicted tail <= budget
    reason: str


class ContractController:
    """Deadline-driven rung selection with degrade/recover hysteresis."""

    def __init__(
        self,
        ladder: Ladder,
        cost: Optional[LadderCostModel] = None,
        cfg: Optional[ControllerConfig] = None,
    ) -> None:
        cfg = cfg if cfg is not None else ControllerConfig()
        self.ladder = ladder
        self.cost = cost if cost is not None else LadderCostModel(ladder)
        self.cfg = cfg
        self._idx = 0                     # current rung (start at the top)
        self._since_switch = cfg.hold_frames   # allow an immediate first move
        self.switches = 0
        self.selections: list[Selection] = []

    @property
    def current(self) -> Rung:
        return self.ladder[self._idx]

    def select(self, budget_s: float,
               feats: Optional[SceneFeatures] = None) -> Selection:
        """Choose the rung for the next frame given its residual budget."""
        if feats is None:
            feats = SceneFeatures()
        if self.cfg.pipeline_depth > 1.0 and feats.pipeline_depth == 1.0:
            feats = dataclasses.replace(
                feats, pipeline_depth=self.cfg.pipeline_depth)
        q = self.cfg.quantile
        chosen: Optional[int] = None
        pred: Optional[Prediction] = None
        reason = ""
        for i, rung in enumerate(self.ladder):
            p = self.cost.predict(rung.name, feats)
            tail = p.quantile(q)
            if i < self._idx:
                # upgrade: needs headroom AND a quiet hold period
                if self._since_switch < self.cfg.hold_frames:
                    continue
                if tail * self.cfg.upgrade_headroom <= budget_s:
                    chosen, pred = i, p
                    reason = (f"upgrade: p{q*100:.0f} {tail*1e3:.2f}ms × "
                              f"{self.cfg.upgrade_headroom:.2f} fits {budget_s*1e3:.2f}ms")
                    break
            elif tail <= budget_s:
                # hold or degrade to the first rung whose tail fits
                verb = "hold" if i == self._idx else "degrade"
                chosen, pred = i, p
                reason = f"{verb}: p{q*100:.0f} {tail*1e3:.2f}ms fits {budget_s*1e3:.2f}ms"
                break
        fits = chosen is not None
        if not fits:
            # nothing fits: run the floor anyway and let the caller decide
            chosen = len(self.ladder) - 1
            pred = self.cost.predict(self.ladder[chosen].name, feats)
            reason = (f"floor: p{q*100:.0f} {pred.quantile(q)*1e3:.2f}ms exceeds "
                      f"budget {budget_s*1e3:.2f}ms")
        if chosen != self._idx:
            self.switches += 1
            self._since_switch = 0
        else:
            self._since_switch += 1
        self._idx = chosen
        sel = Selection(self.ladder[chosen], chosen, pred, fits, reason)
        self.selections.append(sel)
        return sel

    def observe(self, rung_name: str, record: StageRecord, feats: SceneFeatures) -> None:
        """Feed the measured frame back into the cost model."""
        self.cost.observe(rung_name, record, feats)

    def force_degrade(self, steps: int = 1) -> bool:
        """Drop ``steps`` rungs immediately, clamped at the ladder floor.

        The chaos/recovery path's lever: a watchdog-tripped or evacuated
        stream is pushed down the ladder *now*, outside the normal
        budget-fit reasoning, and climbs back only through ``select()``'s
        usual upgrade hysteresis (headroom × hold frames) — so recovery
        is as reluctant as any other upgrade.  Returns False when already
        at the floor (the caller's cue to skip frames instead)."""
        if steps < 1:
            raise ValueError(f"steps must be >= 1 (got {steps})")
        nxt = min(self._idx + steps, len(self.ladder) - 1)
        if nxt == self._idx:
            return False
        self._idx = nxt
        self._since_switch = 0
        self.switches += 1
        return True


class FixedController:
    """Static baseline: always the same rung (the A/B comparator).  Takes
    the same ``ControllerConfig`` as the contract controller so its
    ``fits`` flag is judged against the identical tail quantile."""

    def __init__(
        self,
        ladder: Ladder,
        rung_name: Optional[str] = None,
        cfg: Optional[ControllerConfig] = None,
    ) -> None:
        self.ladder = ladder
        self._idx = 0 if rung_name is None else ladder.index(rung_name)
        self.cost = LadderCostModel(ladder)
        self.cfg = cfg if cfg is not None else ControllerConfig()
        self.switches = 0
        self.selections: list[Selection] = []

    @property
    def current(self) -> Rung:
        return self.ladder[self._idx]

    def select(self, budget_s: float,
               feats: Optional[SceneFeatures] = None) -> Selection:
        if feats is None:
            feats = SceneFeatures()
        rung = self.ladder[self._idx]
        p = self.cost.predict(rung.name, feats)
        fits = p.quantile(self.cfg.quantile) <= budget_s
        sel = Selection(rung, self._idx, p, fits, "fixed")
        self.selections.append(sel)
        return sel

    def observe(self, rung_name: str, record: StageRecord, feats: SceneFeatures) -> None:
        self.cost.observe(rung_name, record, feats)
