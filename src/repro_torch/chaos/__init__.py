"""Deterministic fault injection and graceful degradation (the port of the
reference's ``repro.chaos``, at one shard).

The paper's worst inference-time variations are rare disruptive events:
contention spikes, sensor stalls, device anomalies.  This package makes
them injectable (seeded, virtual-time, byte-reproducible) and makes the
fleet survive them:

* :mod:`~repro_torch.chaos.plan` — declarative :class:`ChaosSpec` compiled
  into a concrete tick-indexed :class:`FaultPlan` (all randomness at
  compile time; the reference's plan JSON byte for byte).
* :mod:`~repro_torch.chaos.inject` — :class:`FaultInjector`, the
  pure-lookup runtime side (shard kills, stalls, corrupt frames, step
  faults, latency spikes).
* :mod:`~repro_torch.chaos.recovery` — :class:`FleetResilience`: per-stream
  hysteretic health machines and transient-fault retry bookkeeping.
* :mod:`~repro_torch.chaos.ledger` — :class:`ChaosLedger`, the
  fault/recovery event log with observability fan-out.
* :mod:`~repro_torch.chaos.catalog` — named chaos episodes
  (``shard_loss_rush_hour``, ``sensor_stall_storm``) and
  :func:`run_chaos_episode`.

The scheduler's recovery paths live in
``repro_torch.batched.scheduler.RungBucketScheduler``.  Everything here
runs on the host: a corrupt frame is dropped from its NumPy image before
anything is staged for the device, so the engines' CUDA graphs see only
finite frames and are never captured anew.

CLI: ``python -m repro_torch.chaos --episode sensor_stall_storm --check``.
"""
from .catalog import (CHAOS_CATALOG, ChaosEpisode, chaos_episode_names,
                      get_chaos_episode, run_chaos_episode)
from .inject import FaultInjector, corrupt_frame
from .ledger import ChaosLedger, LedgerEvent
from .plan import (KINDS, ChaosSpec, FaultClause, FaultEvent, FaultPlan,
                   compile_plan)
from .recovery import (DEGRADED, HEALTHY, QUARANTINED, FleetResilience,
                       ResilienceConfig, StreamHealth)

__all__ = [
    "KINDS", "FaultClause", "ChaosSpec", "FaultEvent", "FaultPlan",
    "compile_plan", "FaultInjector", "corrupt_frame", "ChaosLedger",
    "LedgerEvent", "ResilienceConfig", "StreamHealth", "FleetResilience",
    "HEALTHY", "DEGRADED", "QUARANTINED", "ChaosEpisode", "CHAOS_CATALOG",
    "get_chaos_episode", "chaos_episode_names", "run_chaos_episode",
]
