"""The fault/recovery ledger: every injected fault and every recovery
action, in tick order, with observability fan-out (a copy of the
reference's ``repro/chaos/ledger.py`` but for the instant's tags: see
``ChaosLedger.add``).

One :class:`ChaosLedger` is shared by the injector (``fault_inject``
entries) and the scheduler's recovery paths (``failover`` / ``degrade``
/ ``retry`` / ``watchdog`` / ``recover`` / ...).  When a
``repro_torch.obs.Observatory`` is attached, each entry also lands as a
runtime-axis instant on the episode timeline, so faults and recoveries
are visible in the exported Chrome trace next to the tick spans they
perturbed."""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["LedgerEvent", "ChaosLedger"]


@dataclasses.dataclass(frozen=True)
class LedgerEvent:
    tick: int
    kind: str
    detail: str
    stream: str = ""
    shard: int = -1
    value: float = 0.0

    def to_dict(self) -> dict:
        d = {"tick": self.tick, "kind": self.kind, "detail": self.detail}
        if self.stream:
            d["stream"] = self.stream
        if self.shard >= 0:
            d["shard"] = self.shard
        if self.value:
            d["value"] = self.value
        return d


class ChaosLedger:
    """Append-only fault/recovery event log for one episode."""

    def __init__(self, obs=None) -> None:
        self.obs = obs
        self.events: list[LedgerEvent] = []

    def __len__(self) -> int:
        return len(self.events)

    def add(self, tick: int, kind: str, detail: str, stream: str = "",
            shard: int = -1, value: float = 0.0) -> LedgerEvent:
        ev = LedgerEvent(tick=tick, kind=kind, detail=detail, stream=stream,
                         shard=shard, value=value)
        self.events.append(ev)
        if self.obs is not None:
            # a span has no free-text field: the reference passes
            # ``detail=`` here too and its tracer raises TypeError, so the
            # port leaves the detail in the ledger and tags the instant with
            # kind, tick, stream and shard only
            tags = {"tick": tick, "axis": "runtime"}
            if stream:
                tags["stream"] = stream
            if shard >= 0:
                tags["shard"] = shard
            self.obs.tracer.instant(kind, **tags)
        return ev

    # ---------------- summaries ----------------
    def counts(self) -> dict:
        out: dict[str, int] = {}
        for ev in self.events:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return dict(sorted(out.items()))

    def failovers(self) -> list[LedgerEvent]:
        return [ev for ev in self.events if ev.kind == "failover"]

    def recovery_times(self) -> list[float]:
        """Ticks-to-healthy per ``recover`` event (the recovery-time
        metric the chaos benchmark gates on)."""
        return [ev.value for ev in self.events if ev.kind == "recover"]

    def reseat_ticks(self, kill_tick: Optional[int] = None) -> Optional[int]:
        """Worst ticks-from-kill-to-reseat over every failover, measured
        against ``kill_tick`` (default: the first ``fault_inject`` kill
        in the ledger).  None when nothing failed over."""
        if kill_tick is None:
            kills = [ev.tick for ev in self.events
                     if ev.kind == "fault_inject" and "kill" in ev.detail]
            if not kills:
                return None
            kill_tick = min(kills)
        fo = self.failovers()
        if not fo:
            return None
        return max(ev.tick - kill_tick for ev in fo)

    def to_dict(self) -> dict:
        return {
            "events": [ev.to_dict() for ev in self.events],
            "counts": self.counts(),
            "recovery_ticks": self.recovery_times(),
        }
