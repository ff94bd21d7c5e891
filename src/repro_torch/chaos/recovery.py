"""Per-stream health machines and transient-fault bookkeeping (a copy of
the reference's ``repro/chaos/recovery.py``).

:class:`FleetResilience` is the state the scheduler's recovery paths
consult: a hysteretic three-state health machine per stream (healthy →
degraded → quarantined, recovery as reluctant as the contract
controller's upgrades), plus the armed-fault counter behind bounded
retry-with-backoff.  It owns the episode's :class:`ChaosLedger` so every
transition is recorded exactly once.

State machine (driven by ``note_fault`` / ``note_clean`` /
``age_quarantine``):

* ``healthy`` —fault→ ``degraded`` (rung forced down by the caller)
* ``degraded`` —``quarantine_faults`` cumulative faults→ ``quarantined``
  (frames skipped entirely: a stream feeding garbage or perpetually
  wedged must not keep burning bucket budget)
* ``degraded`` —``recover_ticks`` consecutive clean ticks→ ``healthy``
  (the ``recover`` ledger entry carries ticks-to-healthy)
* ``quarantined`` —``probation_ticks`` skipped ticks→ ``degraded``
  (probation: it may serve again, but one more fault re-quarantines
  immediately since the fault count only resets on full recovery)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .ledger import ChaosLedger

__all__ = ["ResilienceConfig", "StreamHealth", "FleetResilience",
           "HEALTHY", "DEGRADED", "QUARANTINED"]

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    # watchdog: a frame slower than watchdog_scale × its budget is a
    # wedged tick (a plain miss is ~1–2×; fault-free modeled jitter never
    # reaches 4× — the golden byte-identity test depends on that margin)
    watchdog_scale: float = 4.0
    max_retries: int = 3
    backoff_base_s: float = 0.002
    quarantine_faults: int = 3         # cumulative faults → quarantined
    probation_ticks: int = 3           # quarantine dwell before probation
    recover_ticks: int = 3             # consecutive clean ticks → healthy

    def __post_init__(self) -> None:
        if self.watchdog_scale <= 1.0:
            raise ValueError(
                f"watchdog_scale must be > 1 (got {self.watchdog_scale}): "
                f"at <= 1 every ordinary deadline miss would trip it")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0 (got {self.max_retries})")
        if self.backoff_base_s <= 0:
            raise ValueError(
                f"backoff_base_s must be > 0 (got {self.backoff_base_s})")
        for fld in ("quarantine_faults", "probation_ticks", "recover_ticks"):
            if getattr(self, fld) < 1:
                raise ValueError(f"{fld} must be >= 1")


@dataclasses.dataclass
class StreamHealth:
    state: str = HEALTHY
    faults: int = 0                    # cumulative since last full recovery
    clean: int = 0                     # consecutive clean ticks
    unhealthy_since: Optional[int] = None
    q_age: int = 0                     # ticks spent quarantined


class FleetResilience:
    """Health machines + armed transient faults for one episode."""

    def __init__(self, cfg: Optional[ResilienceConfig] = None,
                 ledger: Optional[ChaosLedger] = None) -> None:
        self.cfg = cfg if cfg is not None else ResilienceConfig()
        self.ledger = ledger if ledger is not None else ChaosLedger()
        self.health: dict[str, StreamHealth] = {}
        self._armed = 0

    # ---------------- transient step faults ----------------
    @property
    def armed(self) -> int:
        return self._armed

    def arm_step_faults(self, n: int) -> None:
        """Arm ``n`` engine-step failures: each upcoming bucket step
        consumes one per attempt until the pool drains."""
        self._armed += int(n)

    def take_step_fault(self) -> bool:
        """True (and consumes one armed fault) when the next step attempt
        must fail; False when it proceeds."""
        if self._armed > 0:
            self._armed -= 1
            return True
        return False

    # ---------------- health machine ----------------
    def _h(self, sid: str) -> StreamHealth:
        if sid not in self.health:
            self.health[sid] = StreamHealth()
        return self.health[sid]

    def state(self, sid: str) -> str:
        return self.health.get(sid, StreamHealth()).state

    def is_quarantined(self, sid: str) -> bool:
        return self.state(sid) == QUARANTINED

    def note_fault(self, sid: str, tick: int) -> str:
        """Record one fault against a stream; returns the action the
        scheduler must take: ``"degrade"`` or ``"quarantine"``."""
        h = self._h(sid)
        h.faults += 1
        h.clean = 0
        if h.state == HEALTHY:
            h.state = DEGRADED
            h.unhealthy_since = tick
            return "degrade"
        if h.state == DEGRADED and h.faults >= self.cfg.quarantine_faults:
            h.state = QUARANTINED
            h.q_age = 0
            return "quarantine"
        # already degraded below the quarantine threshold (or already
        # quarantined: a fault during the skip window just resets age)
        if h.state == QUARANTINED:
            h.q_age = 0
            return "quarantine"
        return "degrade"

    def note_clean(self, sid: str, tick: int) -> Optional[int]:
        """Record one clean served tick.  Returns ticks-to-healthy when
        this tick completes a degraded stream's recovery, else None."""
        h = self._h(sid)
        if h.state != DEGRADED:
            return None
        h.clean += 1
        if h.clean < self.cfg.recover_ticks:
            return None
        since = h.unhealthy_since if h.unhealthy_since is not None else tick
        h.state = HEALTHY
        h.faults = 0
        h.clean = 0
        h.unhealthy_since = None
        return max(tick - since, 0)

    def age_quarantine(self, tick: int) -> list[str]:
        """Advance quarantine dwell; returns streams released to
        probation (``degraded``) this tick, sorted for determinism."""
        released = []
        for sid in sorted(self.health):
            h = self.health[sid]
            if h.state != QUARANTINED:
                continue
            h.q_age += 1
            if h.q_age >= self.cfg.probation_ticks:
                h.state = DEGRADED
                h.clean = 0
                # probation: faults stay — one more strike re-quarantines
                h.faults = self.cfg.quarantine_faults - 1
                released.append(sid)
        return released

    def to_dict(self) -> dict:
        return {sid: {"state": h.state, "faults": h.faults}
                for sid, h in sorted(self.health.items())}
