"""Declarative fault specs compiled into deterministic ``FaultPlan``s (a
copy of the reference's ``repro/chaos/plan.py``: pure Python and NumPy,
so a spec compiles to the reference's plan JSON byte for byte).

Mirrors ``scenarios.trace``: a :class:`ChaosSpec` is the declarative
description (clauses with tick windows, targets, and probabilities) and
:func:`compile_plan` expands it — with a seeded generator, iterating
ticks then sorted targets in a fixed order — into a concrete, fully
enumerated :class:`FaultPlan` of per-tick :class:`FaultEvent`\\ s.

Every random draw happens **at compile time**; the runtime injector
(:class:`~repro_torch.chaos.inject.FaultInjector`) only looks events up by
tick.  That split is what keeps chaos attach pure: an empty plan makes
zero draws and changes zero control flow, so a fault-free chaos replay
is byte-identical to the plain golden replay.

Fault kinds (clause ``kind`` → compiled event kinds):

=================  ===========================================  ==============
clause kind        meaning                                      event kinds
=================  ===========================================  ==============
``shard_loss``     a data shard dies at ``at`` and (optionally  ``kill_shard``,
                   ``duration`` ticks later) comes back         ``revive_shard``
``sensor_stall``   a camera stream produces no frames in the    ``stall``
                   window (per-tick, per-stream)
``nan_frame``      a camera delivers non-finite pixel payloads  ``nan_frame``
``step_fault``     ``count`` transient engine-step failures     ``step_fault``
                   armed at the tick (retry-able)
``latency_spike``  contention multiplier ``scale`` for the      ``latency``
                   window (adversarial latency inflation)
=================  ===========================================  ==============
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np

__all__ = ["KINDS", "FaultClause", "ChaosSpec", "FaultEvent", "FaultPlan",
           "compile_plan"]

KINDS = ("shard_loss", "sensor_stall", "step_fault", "latency_spike",
         "nan_frame")

# compiled (runtime) event kinds
EVENT_KINDS = ("kill_shard", "revive_shard", "stall", "nan_frame",
               "step_fault", "latency")

_SEED_MASK = 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class FaultClause:
    """One declarative fault: *what* goes wrong, *when*, to *whom*.

    ``streams`` is the target list for per-stream kinds ("*" = every
    stream known at compile time); ``shard`` targets ``shard_loss``;
    ``probability`` < 1 makes each (tick, target) occurrence an
    independent seeded coin flip at compile time.  ``duration`` is the
    window length in ticks (0 = permanent, allowed only for
    ``shard_loss``)."""

    kind: str
    at: int                            # first tick of the fault window
    duration: int = 1
    streams: tuple = ("*",)
    shard: int = 0
    scale: float = 1.0                 # latency_spike contention multiplier
    count: int = 1                     # step_fault arms per window tick
    probability: float = 1.0

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.at < 0:
            raise ValueError(f"{self.kind}: at must be >= 0 (got {self.at})")
        if self.duration < 0:
            raise ValueError(
                f"{self.kind}: duration must be >= 0 (got {self.duration})")
        if self.duration == 0 and self.kind != "shard_loss":
            raise ValueError(
                f"{self.kind}: duration 0 (permanent) only makes sense for "
                f"shard_loss")
        if not 0.0 < self.probability <= 1.0:
            raise ValueError(
                f"{self.kind}: probability must be in (0, 1] "
                f"(got {self.probability})")
        if self.kind == "latency_spike" and self.scale <= 0:
            raise ValueError(
                f"latency_spike: scale must be > 0 (got {self.scale})")
        if self.kind == "step_fault" and self.count < 1:
            raise ValueError(
                f"step_fault: count must be >= 1 (got {self.count})")
        if self.kind == "shard_loss" and self.shard < 0:
            raise ValueError(
                f"shard_loss: shard must be >= 0 (got {self.shard})")
        object.__setattr__(self, "streams", tuple(self.streams))

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "at": self.at, "duration": self.duration,
            "streams": list(self.streams), "shard": self.shard,
            "scale": self.scale, "count": self.count,
            "probability": self.probability,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultClause":
        return cls(kind=d["kind"], at=d["at"], duration=d.get("duration", 1),
                   streams=tuple(d.get("streams", ("*",))),
                   shard=d.get("shard", 0), scale=d.get("scale", 1.0),
                   count=d.get("count", 1),
                   probability=d.get("probability", 1.0))


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """A named bundle of fault clauses — the declarative side of a chaos
    episode, compiled per (stream set, tick count, seed)."""

    name: str
    description: str
    clauses: tuple

    def __post_init__(self) -> None:
        object.__setattr__(self, "clauses", tuple(self.clauses))

    def to_dict(self) -> dict:
        return {"name": self.name, "description": self.description,
                "clauses": [c.to_dict() for c in self.clauses]}

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosSpec":
        return cls(name=d["name"], description=d.get("description", ""),
                   clauses=tuple(FaultClause.from_dict(c)
                                 for c in d["clauses"]))


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One concrete compiled fault occurrence at one tick."""

    tick: int
    kind: str                         # one of EVENT_KINDS
    stream: str = ""
    shard: int = -1
    value: float = 0.0                # latency scale / step-fault count

    def to_dict(self) -> dict:
        return {"tick": self.tick, "kind": self.kind, "stream": self.stream,
                "shard": self.shard, "value": self.value}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(tick=d["tick"], kind=d["kind"],
                   stream=d.get("stream", ""), shard=d.get("shard", -1),
                   value=d.get("value", 0.0))


class FaultPlan:
    """A fully enumerated fault schedule, indexed by tick.

    Construction builds the per-tick lookup tables the injector reads —
    no randomness, no search at runtime.  ``to_json``/``from_json`` round
    trip byte-identically (sorted keys, compact separators), which is the
    determinism contract the property tests pin down."""

    def __init__(self, name: str, seed: int, n_ticks: int,
                 events: Sequence[FaultEvent]) -> None:
        self.name = name
        self.seed = seed
        self.n_ticks = n_ticks
        self.events = sorted(
            events, key=lambda e: (e.tick, e.kind, e.stream, e.shard))
        # lookup tables, tick -> targets
        self.kills: dict[int, list[int]] = {}
        self.revives: dict[int, list[int]] = {}
        self.stalls: dict[int, set] = {}
        self.nans: dict[int, set] = {}
        self.step_faults: dict[int, int] = {}
        self.latency: dict[int, float] = {}
        for e in self.events:
            if e.kind == "kill_shard":
                self.kills.setdefault(e.tick, []).append(e.shard)
            elif e.kind == "revive_shard":
                self.revives.setdefault(e.tick, []).append(e.shard)
            elif e.kind == "stall":
                self.stalls.setdefault(e.tick, set()).add(e.stream)
            elif e.kind == "nan_frame":
                self.nans.setdefault(e.tick, set()).add(e.stream)
            elif e.kind == "step_fault":
                self.step_faults[e.tick] = (
                    self.step_faults.get(e.tick, 0) + int(e.value))
            elif e.kind == "latency":
                # overlapping spikes compound multiplicatively
                self.latency[e.tick] = self.latency.get(e.tick, 1.0) * e.value
            else:
                raise ValueError(f"unknown event kind {e.kind!r}")

    @classmethod
    def empty(cls, name: str = "no-faults") -> "FaultPlan":
        """The identity plan: attaching it must not perturb a replay."""
        return cls(name=name, seed=0, n_ticks=0, events=())

    @property
    def is_empty(self) -> bool:
        return not self.events

    # ---------------- serialization ----------------
    def to_dict(self) -> dict:
        return {"name": self.name, "seed": self.seed, "n_ticks": self.n_ticks,
                "events": [e.to_dict() for e in self.events]}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent,
                          separators=(",", ": ") if indent else (",", ":"))

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(name=d["name"], seed=d["seed"], n_ticks=d["n_ticks"],
                   events=[FaultEvent.from_dict(e) for e in d["events"]])

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2) + "\n")

    @classmethod
    def load(cls, path) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())


def _clause_rng(seed: int, idx: int) -> np.random.Generator:
    # same per-element seeding shape as scenarios.trace.compile_trace: one
    # independent, reproducible stream per clause
    return np.random.default_rng((seed * 1_000_003 + idx * 7919 + 23)
                                 & _SEED_MASK)


def compile_plan(spec: ChaosSpec, streams: Sequence[str], n_ticks: int,
                 seed: int) -> FaultPlan:
    """Expand a declarative spec into concrete per-tick events.

    Deterministic by construction: clauses are expanded in declaration
    order, each with its own seeded generator, windows iterate tick-major
    and targets in sorted order, and draws happen only for probabilistic
    clauses (p < 1) — so an all-certain spec compiles identically under
    any seed.  Events at or past ``n_ticks`` are clipped (a shard revive
    past the horizon simply never happens)."""
    all_streams = sorted(streams)
    events: list[FaultEvent] = []
    for ci, clause in enumerate(spec.clauses):
        rng = _clause_rng(seed, ci)
        if clause.kind == "shard_loss":
            if clause.at < n_ticks:
                events.append(FaultEvent(tick=clause.at, kind="kill_shard",
                                         shard=clause.shard))
                revive = clause.at + clause.duration
                if clause.duration > 0 and revive < n_ticks:
                    events.append(FaultEvent(tick=revive, kind="revive_shard",
                                             shard=clause.shard))
            continue
        targets = (all_streams if clause.streams == ("*",)
                   else sorted(clause.streams))
        end = min(clause.at + clause.duration, n_ticks)
        for tick in range(clause.at, end):
            if clause.kind == "step_fault":
                if clause.probability >= 1.0 or rng.random() < clause.probability:
                    events.append(FaultEvent(tick=tick, kind="step_fault",
                                             value=float(clause.count)))
                continue
            if clause.kind == "latency_spike":
                if clause.probability >= 1.0 or rng.random() < clause.probability:
                    events.append(FaultEvent(tick=tick, kind="latency",
                                             value=float(clause.scale)))
                continue
            kind = "stall" if clause.kind == "sensor_stall" else "nan_frame"
            for sid in targets:
                if clause.probability >= 1.0 or rng.random() < clause.probability:
                    events.append(FaultEvent(tick=tick, kind=kind, stream=sid))
    return FaultPlan(name=spec.name, seed=seed, n_ticks=n_ticks,
                     events=events)
