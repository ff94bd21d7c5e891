"""Anytime perception: a deadline-driven multi-fidelity inference subsystem.

The paper shows perception latency is data-dependent; a serving runtime can
only *shed* a frame about to miss its deadline.  This subsystem trades
quality for time instead:

* ``ladder``     — ordered pipeline fidelity rungs (two-stage → λ-scaled
                   one-stage → truncated-backbone early exit), each with
                   quality calibrated against synthetic-scene ground truth.
* ``cost``       — per-rung, per-stage latency prediction from observable
                   scene features + online Kalman/feature estimators, with
                   quantile (tail) estimates.
* ``controller`` — the contract controller: highest-quality rung whose
                   predicted tail fits the residual deadline, degrade
                   immediately, recover with hysteresis.
* ``runner``     — the stage-timed anytime frame loop and its report.

The port of ``repro.anytime``.
"""
from .controller import ContractController, ControllerConfig, FixedController, Selection
from .cost import LadderCostModel, RungCostModel, SceneFeatures
from .ladder import (
    Ladder,
    Rung,
    calibrate,
    default_rungs,
    frame_quality,
    rung_stage_specs,
)
from .runner import AnytimeReport, FrameResult, build_rungs, run_anytime

__all__ = [
    "ContractController",
    "ControllerConfig",
    "FixedController",
    "Selection",
    "LadderCostModel",
    "RungCostModel",
    "SceneFeatures",
    "Ladder",
    "Rung",
    "calibrate",
    "default_rungs",
    "frame_quality",
    "rung_stage_specs",
    "AnytimeReport",
    "FrameResult",
    "build_rungs",
    "run_anytime",
]
