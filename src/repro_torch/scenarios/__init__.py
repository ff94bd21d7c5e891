"""Scenario-trace subsystem: time-varying driving episodes, deterministic
replay through the batched perception stack, and golden variation reports.

The paper's central claim is that inference-time variation is driven by
*changing conditions* — scene content (Insight 1), weather (Table IV),
co-resident contention (§IV) and system load (§VII) — yet a stationary
benchmark stream never exercises a regime change.  This package turns the
static scene generator into replayable episodes:

* ``trace``   — the ``ScenarioTrace`` format (timestamped segments with a
  scenario mix, rain ramp, per-stream dropout, contention/budget profile)
  plus a seeded compiler from high-level ``Episode`` specs,
* ``catalog`` — named episodes (rush hour, rain onset, tunnel dropout,
  contention spike, camera churn, adversarial latency-attack ramp, …),
* ``replay``  — ``ScenarioReplayer``: drives the batched engine + rung
  scheduler + contract controllers under ``SimClock`` virtual time and
  emits a per-segment ``VariationReport``,
* ``golden``  — tolerance-banded report comparison so episodes become
  golden regression fixtures (also a CLI: ``python -m
  repro_torch.scenarios --check``).

The port of the reference's ``repro.scenarios``; the replayer takes
chaos plans (``repro_torch.chaos``) and device meshes
(``repro_torch.launch.mesh``).
"""
from .catalog import CATALOG, episode_names, get_episode
from .golden import Tolerance, compare_reports, golden_replay
from .replay import (
    ModeledStageCost,
    ScenarioReplayer,
    SegmentReport,
    VariationReport,
    replay_ladder,
)
from .trace import Episode, Phase, ScenarioTrace, Segment, compile_trace

__all__ = [
    "Episode",
    "Phase",
    "Segment",
    "ScenarioTrace",
    "compile_trace",
    "CATALOG",
    "get_episode",
    "episode_names",
    "ScenarioReplayer",
    "ModeledStageCost",
    "VariationReport",
    "SegmentReport",
    "replay_ladder",
    "Tolerance",
    "compare_reports",
    "golden_replay",
]
