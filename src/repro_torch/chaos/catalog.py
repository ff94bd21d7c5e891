"""Named chaos episodes: a base scenario episode plus a fault spec (the
reference's ``repro/chaos/catalog.py``; the episodes copied verbatim).

These live in their own catalog (not ``scenarios.catalog``) because a
chaos episode is a *pair* — the nominal drive and what breaks during it
— and carries runtime configuration (mesh width, capacity) the plain
scenario episodes don't have.

| chaos episode         | faults exercised                                |
|-----------------------|-------------------------------------------------|
| shard_loss_rush_hour  | data-shard death + revival mid rush hour:       |
|                       | retrace-free failover, capacity-pressure        |
|                       | degrade, drift-back rebalance                   |
| sensor_stall_storm    | stalls, corrupt frames, a latency spike and     |
|                       | transient step faults: ingest quarantine,       |
|                       | watchdog degrade, bounded retry, recovery       |

An episode that wants more than one data shard (``shard_loss_rush_hour``,
``mesh_data=2``) runs on a mesh that gives it them
(``repro_torch.launch.mesh.make_local_mesh(data=2, devices=[d, d])`` puts
two shards on one device); on a narrower one its kill of shard 1 raises
``ValueError``, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..scenarios.catalog import get_episode
from ..scenarios.replay import ScenarioReplayer
from ..scenarios.trace import compile_trace

from .plan import ChaosSpec, FaultClause, compile_plan

__all__ = ["ChaosEpisode", "CHAOS_CATALOG", "get_chaos_episode",
           "chaos_episode_names", "run_chaos_episode"]


@dataclasses.dataclass(frozen=True)
class ChaosEpisode:
    """A nominal drive (``base`` scenario episode) plus its fault spec
    and the fleet configuration it runs under."""

    name: str
    description: str
    base: str                          # scenarios.catalog episode name
    spec: ChaosSpec
    seed: int = 0
    mesh_data: int = 1                 # data-axis width the episode wants
    capacity: Optional[int] = None     # None = trace's peak stream count
    tick_scale: float = 1.0


def _episodes() -> dict[str, ChaosEpisode]:
    eps = [
        ChaosEpisode(
            name="shard_loss_rush_hour",
            description="Rush hour on a 2-shard fleet; one data shard "
                        "dies mid-densification and comes back during "
                        "downtown.  Every stream seated on the dead shard "
                        "must fail over (slot churn only — zero backend "
                        "compiles) within the reseat bound.",
            base="urban_rush_hour",
            mesh_data=2,
            # twice the stream count: the surviving shard has free slots,
            # so evacuation completes in the kill tick itself
            capacity=8,
            spec=ChaosSpec(
                name="shard_loss_rush_hour",
                description="kill shard 1 at tick 8, revive at tick 20",
                clauses=(
                    FaultClause(kind="shard_loss", at=8, duration=12,
                                shard=1),
                ),
            ),
        ),
        ChaosEpisode(
            name="sensor_stall_storm",
            description="Rain episode with a storm of sensor-level faults: "
                        "a hard left-camera stall, a flaky right camera, a "
                        "front camera feeding corrupt (non-finite) frames, "
                        "an adversarial latency spike, and transient step "
                        "failures.  Exercises ingest quarantine, the "
                        "watchdog, bounded retry and hysteretic recovery.",
            base="rain_onset_clear",
            spec=ChaosSpec(
                name="sensor_stall_storm",
                description="stalls + NaN frames + latency spike + "
                            "transient step faults",
                clauses=(
                    FaultClause(kind="sensor_stall", at=6, duration=6,
                                streams=("cam_left",)),
                    FaultClause(kind="sensor_stall", at=9, duration=7,
                                streams=("cam_right",), probability=0.7),
                    FaultClause(kind="nan_frame", at=12, duration=7,
                                streams=("cam_front",), probability=0.6),
                    # must push served latency past watchdog_scale (4.0) x
                    # budget while streams still sit on the heavy rungs:
                    # at x10 the first spike tick lands ~4.7x budget on
                    # two_stage, then the controllers degrade below it
                    FaultClause(kind="latency_spike", at=14, duration=6,
                                scale=10.0),
                    FaultClause(kind="step_fault", at=16, duration=2,
                                count=2),
                ),
            ),
        ),
    ]
    return {e.name: e for e in eps}


CHAOS_CATALOG: dict[str, ChaosEpisode] = _episodes()


def get_chaos_episode(name: str) -> ChaosEpisode:
    try:
        return CHAOS_CATALOG[name]
    except KeyError:
        raise KeyError(f"unknown chaos episode {name!r}; "
                       f"catalog: {sorted(CHAOS_CATALOG)}") from None


def chaos_episode_names() -> list[str]:
    return sorted(CHAOS_CATALOG)


def run_chaos_episode(name: str, mesh=None, scheduler=None, sentinel=None,
                      obs=None, seed: Optional[int] = None,
                      tick_scale: Optional[float] = None, device=None):
    """Replay one chaos episode deterministically.

    Compiles the base scenario trace and the fault plan under the
    episode's seed, then replays with the injector attached.  Returns
    ``(VariationReport, ScenarioReplayer, FaultPlan)`` — the report's
    ``chaos`` block holds the fault/recovery ledger, and
    ``replayer.scheduler`` exposes each engine's captures for the
    zero-capture gate.  ``scheduler`` reuses a built scheduler (reset
    first); otherwise one is built at the episode's capacity on ``device``
    (the card unless ``"cpu"`` is asked for).  ``sentinel`` is any context
    manager around the tick loop (see ``ScenarioReplayer.run``).  ``mesh``
    must span the episode's ``mesh_data`` shards (build one with
    ``repro_torch.launch.mesh.make_local_mesh``); omit it for one-shard
    episodes.  A reused scheduler keeps its own mesh."""
    ep = get_chaos_episode(name)
    seed = ep.seed if seed is None else seed
    tick_scale = ep.tick_scale if tick_scale is None else tick_scale
    trace = compile_trace(get_episode(ep.base), seed=seed,
                          tick_scale=tick_scale)
    plan = compile_plan(ep.spec, trace.streams, trace.n_ticks, seed)
    replayer = ScenarioReplayer(
        trace, scheduler=scheduler,
        capacity=(ep.capacity if scheduler is None else None),
        mesh=mesh if scheduler is None else None,
        obs=obs, chaos=plan, device=device)
    report = replayer.run(sentinel=sentinel)
    return report, replayer, plan
