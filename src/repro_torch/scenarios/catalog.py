"""Named episode catalog — the scenario classes the paper (and the
related attack/tail-quality work) says a perception stack must survive.
The episodes are the reference's (``repro/scenarios/catalog.py``),
copied verbatim.

Every episode is a high-level ``Episode`` spec; ``compile_trace`` turns
it into a replayable ``ScenarioTrace``.  Tick counts are deliberately
small (an episode replays end-to-end in seconds on CPU) — benchmarks
stretch them with ``tick_scale``.

| episode              | regime change exercised                           |
|----------------------|---------------------------------------------------|
| urban_rush_hour      | scene-density ramp: road → dense city (Insight 1) |
| highway_cruise       | stationary sparse baseline (control episode)      |
| tunnel_entry         | sensor dropout burst on every camera (§IV-C)      |
| rain_onset_clear     | rain 0 → heavy → 0 (Table IV)                     |
| cut_in_burst         | short dense-object bursts in a calm stream        |
| contention_spike     | co-tenant latency spike + budget squeeze (§IV)    |
| camera_churn         | cameras join/leave mid-episode (batched slots)    |
| latency_attack_ramp  | adversarial density+contention ramp (attack paper)|
"""
from __future__ import annotations

from .trace import Episode, Phase

__all__ = ["CATALOG", "get_episode", "episode_names"]

_CAMS3 = ("cam_front", "cam_left", "cam_right")
_CAMS4 = ("cam_front", "cam_left", "cam_right", "cam_rear")


def _episodes() -> dict[str, Episode]:
    eps = [
        Episode(
            name="urban_rush_hour",
            description="Sparse arterial road densifying into downtown "
                        "rush hour: object counts (and post-processing "
                        "work) ramp up while deadlines stay fixed.",
            streams=_CAMS4,
            phases=(
                Phase("arterial", ticks=8,
                      scenario_mix={"road": 0.7, "residential": 0.3}),
                Phase("densifying", ticks=10, split=2,
                      scenario_mix={"residential": 0.5, "city": 0.5},
                      contention=(1.0, 1.3)),
                Phase("downtown", ticks=10,
                      scenario_mix={"city": 1.0},
                      contention=(1.3, 1.3)),
            ),
        ),
        Episode(
            name="highway_cruise",
            description="Stationary sparse highway driving — the control "
                        "episode: no regime change, variance comes only "
                        "from scene noise.",
            streams=_CAMS3,
            phases=(
                Phase("cruise_a", ticks=10, scenario_mix={"road": 1.0}),
                Phase("cruise_b", ticks=10, scenario_mix={"road": 1.0}),
            ),
        ),
        Episode(
            name="tunnel_entry",
            description="Tunnel transit: every camera drops most frames "
                        "mid-episode, starving fusion and the batched "
                        "engine's ticks.",
            streams=_CAMS3,
            phases=(
                Phase("approach", ticks=8, scenario_mix={"road": 1.0}),
                Phase("tunnel", ticks=8, scenario_mix={"road": 1.0},
                      dropout={"*": 0.6}),
                Phase("exit", ticks=8, scenario_mix={"road": 0.6, "residential": 0.4}),
            ),
        ),
        Episode(
            name="rain_onset_clear",
            description="Dry city driving, heavy rain moving in and "
                        "clearing again (Table IV: rain occludes objects, "
                        "mean AND variance of post time drop).",
            streams=_CAMS3,
            phases=(
                Phase("dry", ticks=6, scenario_mix={"city": 1.0}),
                Phase("onset", ticks=10, split=2,
                      scenario_mix={"city": 1.0}, rain=(0.0, 150.0)),
                Phase("downpour", ticks=6, scenario_mix={"city": 1.0},
                      rain=(150.0, 150.0)),
                Phase("clearing", ticks=8, scenario_mix={"city": 1.0},
                      rain=(150.0, 0.0)),
            ),
        ),
        Episode(
            name="cut_in_burst",
            description="Calm residential stream punctuated by short "
                        "dense-object bursts (cut-in traffic): the "
                        "proposal-count spike the paper correlates with "
                        "post-processing time.",
            streams=_CAMS3,
            phases=(
                Phase("calm_a", ticks=7, scenario_mix={"residential": 1.0}),
                Phase("burst_a", ticks=4, scenario_mix={"city": 1.0}),
                Phase("calm_b", ticks=7, scenario_mix={"residential": 1.0}),
                Phase("burst_b", ticks=4, scenario_mix={"city": 1.0}),
                Phase("calm_c", ticks=6, scenario_mix={"residential": 1.0}),
            ),
        ),
        Episode(
            name="contention_spike",
            description="A co-tenant task spikes accelerator/host "
                        "contention and squeezes the residual budget; the "
                        "contract controllers must degrade through it and "
                        "recover after (§IV / anytime contract).",
            streams=_CAMS4,
            phases=(
                Phase("nominal", ticks=8, scenario_mix={"city": 1.0}),
                Phase("spike", ticks=10, split=2, scenario_mix={"city": 1.0},
                      contention=(1.0, 2.6), budget_scale=(1.0, 0.7)),
                Phase("recovery", ticks=10, scenario_mix={"city": 1.0},
                      contention=(2.6, 1.0), budget_scale=(0.7, 1.0)),
            ),
        ),
        Episode(
            name="camera_churn",
            description="Cameras join and leave mid-episode (parking "
                        "assist engaging extra sensors): slot churn in the "
                        "batched engine must never retrace or disturb "
                        "surviving streams.",
            streams=("cam_front", "cam_left"),
            phases=(
                Phase("two_up", ticks=7, scenario_mix={"residential": 1.0}),
                Phase("four_up", ticks=9, scenario_mix={"residential": 1.0},
                      join=("cam_right", "cam_rear")),
                Phase("three_up", ticks=8, scenario_mix={"residential": 1.0},
                      leave=("cam_left",)),
            ),
        ),
        Episode(
            name="latency_attack_ramp",
            description="Adversarially-timed input perturbation (per the "
                        "inference-time attack paper): scene density is "
                        "forced to maximum while contention ramps, "
                        "inflating post-processing until deadlines break; "
                        "the attack then stops.",
            streams=_CAMS3,
            phases=(
                Phase("benign", ticks=8,
                      scenario_mix={"residential": 0.6, "road": 0.4}),
                Phase("attack", ticks=12, split=3,
                      scenario_mix={"city": 1.0},
                      contention=(1.0, 3.0)),
                Phase("released", ticks=8,
                      scenario_mix={"residential": 0.6, "road": 0.4},
                      contention=(1.0, 1.0)),
            ),
        ),
    ]
    return {e.name: e for e in eps}


CATALOG: dict[str, Episode] = _episodes()


def get_episode(name: str) -> Episode:
    try:
        return CATALOG[name]
    except KeyError:
        raise KeyError(f"unknown episode {name!r}; "
                       f"catalog: {sorted(CATALOG)}") from None


def episode_names() -> list[str]:
    return sorted(CATALOG)
