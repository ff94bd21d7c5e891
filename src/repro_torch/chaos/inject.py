"""The runtime fault injector: pure lookups into a compiled ``FaultPlan``
(a copy of the reference's ``repro/chaos/inject.py``).

``FaultInjector`` sits between the replayer's scene generation and the
scheduler's tick: it kills/revives shards and arms transient step faults
(``pre_tick``), removes stalled streams' frames and corrupts NaN-targeted
payloads (``filter_scenes``), and scales the tick's contention for
latency spikes (``latency_scale``).  It draws no randomness and holds no
hidden state — every decision was made at plan compile time — so two
runs of the same plan perturb a replay identically, and an empty plan
perturbs nothing at all."""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

from .ledger import ChaosLedger
from .plan import FaultPlan

__all__ = ["FaultInjector", "corrupt_frame"]


def corrupt_frame(scene):
    """A copy of ``scene`` whose image carries non-finite pixels (every
    4th pixel in both axes NaN) — the corrupt-payload fault the ingest
    guard must catch before the engine sees it.  It works on the host
    NumPy image: the guard checks finiteness there too, so a corrupt
    frame never reaches the device (nor a captured CUDA graph)."""
    img = np.asarray(scene.image, np.float32).copy()
    img[0::4, 0::4] = np.nan
    return dataclasses.replace(scene, image=img)


class FaultInjector:
    """Replay-side injector for one compiled :class:`FaultPlan`."""

    def __init__(self, plan: FaultPlan,
                 ledger: Optional[ChaosLedger] = None) -> None:
        self.plan = plan
        self.ledger = ledger if ledger is not None else ChaosLedger()

    def latency_scale(self, tick: int) -> float:
        """Contention multiplier injected at this tick (1.0 = none)."""
        return self.plan.latency.get(tick, 1.0)

    def pre_tick(self, tick: int, sched) -> None:
        """Apply this tick's infrastructure faults to the scheduler:
        shard kills/revives and armed transient step failures."""
        for shard in self.plan.kills.get(tick, ()):
            self.ledger.add(tick, "fault_inject",
                            f"kill shard {shard}", shard=shard)
            sched.kill_shard(shard)
        for shard in self.plan.revives.get(tick, ()):
            self.ledger.add(tick, "fault_inject",
                            f"revive shard {shard}", shard=shard)
            sched.revive_shard(shard)
        n = self.plan.step_faults.get(tick, 0)
        if n and sched.resilience is not None:
            self.ledger.add(tick, "fault_inject",
                            f"arm {n} transient step fault(s)",
                            value=float(n))
            sched.resilience.arm_step_faults(n)
        scale = self.plan.latency.get(tick)
        if scale is not None:
            self.ledger.add(tick, "fault_inject",
                            f"latency spike x{scale:g}", value=scale)

    def filter_scenes(self, tick: int, scenes: Mapping) -> dict:
        """Apply this tick's sensor faults: stalled streams lose their
        frame entirely (the scheduler counts a drop, as for any sensor
        dropout); NaN-targeted streams deliver a corrupted payload for
        the ingest guard to quarantine.  Iteration preserves the caller's
        scene order so downstream RNG consumption is untouched."""
        stalled = self.plan.stalls.get(tick, ())
        nans = self.plan.nans.get(tick, ())
        if not stalled and not nans:
            return dict(scenes)
        out = {}
        for sid, scene in scenes.items():
            if sid in stalled:
                self.ledger.add(tick, "fault_inject",
                                "sensor stall: frame withheld", stream=sid)
                continue
            if sid in nans:
                self.ledger.add(tick, "fault_inject",
                                "corrupt frame: non-finite payload",
                                stream=sid)
                scene = corrupt_frame(scene)
            out[sid] = scene
        return out
