"""The ``ScenarioTrace`` format and its compiler (the port of the
reference's ``repro/scenarios/trace.py``: pure Python and NumPy, so a
trace compiled here serializes byte for byte as the reference's does).

A trace is a list of timestamped **segments**; each segment holds the
condition knobs the paper identifies as variance drivers, all of which
may ramp linearly across the segment:

* ``scenario_mix``   — probability mix over the scene generator's
  scenarios (city / residential / road): scene *content* (Insight 1),
* ``rain``           — rain-rate ramp in mm/h (Table IV),
* ``dropout``        — per-stream frame-drop probability (sensor loss,
  tunnel entry, the fusion experiments of §IV-C),
* ``contention``     — multiplier on modeled stage latencies (co-resident
  tasks stealing the accelerator/host, §IV),
* ``budget_scale``   — multiplier on the per-frame deadline budget
  (system-load squeeze, §VII),
* ``join`` / ``leave`` — camera churn at segment start.

Traces are plain data with an exact JSON round trip, so episodes can be
checked in as fixtures.  High-level ``Episode`` specs (phases) compile
into traces with ``compile_trace(episode, seed)``: phases are split into
piecewise-linear segments, timestamps are laid out on the tick period,
and every segment gets a derived sub-seed so replay is reproducible
without the compiler in the loop.
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Iterator, Mapping, Sequence

from ..perception.data import SCENARIOS, SceneConfig

__all__ = ["Phase", "Episode", "Segment", "ScenarioTrace", "compile_trace"]

_SEED_MASK = 0x7FFFFFFF


def _lerp(lo: float, hi: float, frac: float) -> float:
    return lo + (hi - lo) * frac


def _check_ramp(name: str, ramp: Sequence[float], positive: bool = False) -> tuple[float, float]:
    if len(ramp) != 2:
        raise ValueError(f"{name} must be a (start, end) pair, got {ramp!r}")
    lo, hi = float(ramp[0]), float(ramp[1])
    if positive and (lo <= 0 or hi <= 0):
        raise ValueError(f"{name} must stay positive, got {ramp!r}")
    if not positive and (lo < 0 or hi < 0):
        raise ValueError(f"{name} must be non-negative, got {ramp!r}")
    return lo, hi


def _check_mix(mix: Mapping[str, float]) -> dict[str, float]:
    if not mix:
        raise ValueError("scenario_mix cannot be empty")
    unknown = set(mix) - set(SCENARIOS)
    if unknown:
        raise ValueError(f"unknown scenarios {sorted(unknown)}; "
                         f"known: {sorted(SCENARIOS)}")
    total = float(sum(mix.values()))
    if total <= 0 or any(v < 0 for v in mix.values()):
        raise ValueError(f"scenario_mix weights must be >= 0 and sum > 0: {dict(mix)}")
    return {k: float(v) / total for k, v in mix.items()}


def _check_dropout(dropout: Mapping[str, float]) -> dict[str, float]:
    out = {}
    for k, v in dropout.items():
        v = float(v)
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"dropout[{k!r}] = {v} is not a probability")
        out[str(k)] = v
    return out


@dataclasses.dataclass(frozen=True)
class Phase:
    """One high-level episode phase: condition knobs over ``ticks`` frames.

    ``split`` expands the phase into that many piecewise-linear segments
    at compile time, so a long ramp yields multiple per-segment rows in
    the variation report (the regression fixtures compare per-segment
    statistics, and a single 40-tick segment would average the regime
    change away).
    """

    label: str
    ticks: int
    scenario_mix: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"city": 1.0})
    rain: tuple[float, float] = (0.0, 0.0)
    dropout: Mapping[str, float] = dataclasses.field(default_factory=dict)
    contention: tuple[float, float] = (1.0, 1.0)
    budget_scale: tuple[float, float] = (1.0, 1.0)
    join: tuple[str, ...] = ()
    leave: tuple[str, ...] = ()
    split: int = 1

    def __post_init__(self) -> None:
        if self.ticks < 1:
            raise ValueError(f"phase {self.label!r}: ticks must be >= 1")
        if self.split < 1 or self.split > self.ticks:
            raise ValueError(
                f"phase {self.label!r}: split must be in [1, ticks]")
        _check_mix(self.scenario_mix)
        _check_ramp("rain", self.rain)
        _check_dropout(self.dropout)
        _check_ramp("contention", self.contention, positive=True)
        _check_ramp("budget_scale", self.budget_scale, positive=True)


@dataclasses.dataclass(frozen=True)
class Episode:
    """A named, self-contained driving episode spec (see ``catalog``)."""

    name: str
    description: str
    streams: tuple[str, ...]
    phases: tuple[Phase, ...]
    budget_s: float = 0.016
    period_s: float = 0.1

    def __post_init__(self) -> None:
        if not self.streams:
            raise ValueError(f"episode {self.name!r} has no streams")
        if not self.phases:
            raise ValueError(f"episode {self.name!r} has no phases")
        if self.budget_s <= 0 or self.period_s <= 0:
            raise ValueError(f"episode {self.name!r}: budget_s and period_s "
                             "must be positive")


@dataclasses.dataclass(frozen=True)
class Segment:
    """One compiled piecewise-linear slice of an episode."""

    label: str
    t_start: float
    n_ticks: int
    scenario_mix: dict[str, float]
    rain: tuple[float, float]
    dropout: dict[str, float]
    contention: tuple[float, float]
    budget_scale: tuple[float, float]
    join: tuple[str, ...] = ()
    leave: tuple[str, ...] = ()
    seed: int = 0

    # ---- per-tick interpolation (k in [0, n_ticks)) ----
    def frac(self, k: int) -> float:
        return k / max(self.n_ticks - 1, 1)

    def rain_at(self, k: int) -> float:
        return _lerp(self.rain[0], self.rain[1], self.frac(k))

    def contention_at(self, k: int) -> float:
        return _lerp(self.contention[0], self.contention[1], self.frac(k))

    def budget_scale_at(self, k: int) -> float:
        return _lerp(self.budget_scale[0], self.budget_scale[1], self.frac(k))

    def dropout_for(self, stream_id: str) -> float:
        """Per-stream drop probability; ``"*"`` is the all-streams key."""
        return self.dropout.get(stream_id, self.dropout.get("*", 0.0))


@dataclasses.dataclass
class ScenarioTrace:
    """A compiled, replayable episode: segments on a shared tick timeline."""

    name: str
    seed: int
    period_s: float
    budget_s: float
    streams: tuple[str, ...]
    segments: list[Segment]

    def __post_init__(self) -> None:
        self.streams = tuple(self.streams)
        if not self.segments:
            raise ValueError(f"trace {self.name!r} has no segments")
        # churn must be consistent: never leave an unseated stream or
        # join a seated one — validated here so from_json() is safe too
        active = set(self.streams)
        if len(active) != len(self.streams):
            raise ValueError(f"duplicate stream ids: {self.streams}")
        peak = len(active)
        for seg in self.segments:
            bad = set(seg.leave) - active
            if bad:
                raise ValueError(
                    f"segment {seg.label!r} leaves unseated streams {sorted(bad)}")
            active -= set(seg.leave)
            dup = set(seg.join) & active
            if dup:
                raise ValueError(
                    f"segment {seg.label!r} joins already-seated streams {sorted(dup)}")
            active |= set(seg.join)
            if not active:
                raise ValueError(f"segment {seg.label!r} leaves zero streams seated")
            peak = max(peak, len(active))
        self._peak_streams = peak

    # ---- timeline ----
    @property
    def n_ticks(self) -> int:
        return sum(s.n_ticks for s in self.segments)

    @property
    def duration_s(self) -> float:
        return self.n_ticks * self.period_s

    def max_concurrent_streams(self) -> int:
        """Peak seated-stream count over the whole trace (engine capacity)."""
        return self._peak_streams

    def segment_of(self, tick: int) -> tuple[Segment, int]:
        """(segment, tick-within-segment) for a global tick index."""
        if tick < 0:
            raise IndexError(f"tick {tick} < 0")
        k = tick
        for seg in self.segments:
            if k < seg.n_ticks:
                return seg, k
            k -= seg.n_ticks
        # past the end: conditions hold at the final segment's endpoint
        last = self.segments[-1]
        return last, last.n_ticks - 1

    def budget_at_tick(self, tick: int) -> float:
        seg, k = self.segment_of(tick)
        return self.budget_s * seg.budget_scale_at(k)

    def contention_at_tick(self, tick: int) -> float:
        seg, k = self.segment_of(tick)
        return seg.contention_at(k)

    def rain_at_tick(self, tick: int) -> float:
        seg, k = self.segment_of(tick)
        return seg.rain_at(k)

    def structure(self) -> list[dict]:
        """The seed-independent shape of the trace: what a property test
        asserts is identical across compile seeds."""
        return [{"label": s.label, "t_start": s.t_start, "n_ticks": s.n_ticks,
                 "join": list(s.join), "leave": list(s.leave)}
                for s in self.segments]

    # ---- per-stream scene parameterization (single-stream anytime path) ----
    def stream_configs(self, stream_id: str) -> Iterator[tuple[SceneConfig, int]]:
        """Segment-parameterized ``(SceneConfig, index)`` sequence for one
        stream — feed it to ``perception.data.varied_scene_stream`` to get
        the trace's time-varying frames without the multi-stream replayer
        (e.g. ``anytime.run_anytime(scene_fn=...)``).  Scenario draws use a
        dedicated per-stream generator so this path is deterministic and
        independent of replayer state."""
        import numpy as np

        rng = np.random.default_rng(
            (self.seed * 1_000_003 + zlib.crc32(stream_id.encode())) & _SEED_MASK)
        tick = 0
        for seg in self.segments:
            for k in range(seg.n_ticks):
                scenario = draw_scenario(rng, seg.scenario_mix)
                cfg = SceneConfig(
                    scenario=scenario,
                    rain_mm_per_hour=seg.rain_at(k),
                    seed=stream_seed(seg.seed, stream_id),
                )
                yield cfg, tick
                tick += 1

    # ---- JSON round trip ----
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "period_s": self.period_s,
            "budget_s": self.budget_s,
            "streams": list(self.streams),
            "segments": [
                {
                    "label": s.label,
                    "t_start": s.t_start,
                    "n_ticks": s.n_ticks,
                    "scenario_mix": dict(s.scenario_mix),
                    "rain": list(s.rain),
                    "dropout": dict(s.dropout),
                    "contention": list(s.contention),
                    "budget_scale": list(s.budget_scale),
                    "join": list(s.join),
                    "leave": list(s.leave),
                    "seed": s.seed,
                }
                for s in self.segments
            ],
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ScenarioTrace":
        segments = [
            Segment(
                label=s["label"],
                t_start=float(s["t_start"]),
                n_ticks=int(s["n_ticks"]),
                scenario_mix={k: float(v) for k, v in s["scenario_mix"].items()},
                rain=(float(s["rain"][0]), float(s["rain"][1])),
                dropout={k: float(v) for k, v in s.get("dropout", {}).items()},
                contention=(float(s["contention"][0]), float(s["contention"][1])),
                budget_scale=(float(s["budget_scale"][0]), float(s["budget_scale"][1])),
                join=tuple(s.get("join", ())),
                leave=tuple(s.get("leave", ())),
                seed=int(s.get("seed", 0)),
            )
            for s in d["segments"]
        ]
        return cls(
            name=d["name"],
            seed=int(d["seed"]),
            period_s=float(d["period_s"]),
            budget_s=float(d["budget_s"]),
            streams=tuple(d["streams"]),
            segments=segments,
        )

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent,
                          separators=(",", ": ") if indent else (",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "ScenarioTrace":
        return cls.from_dict(json.loads(text))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2) + "\n")

    @classmethod
    def load(cls, path) -> "ScenarioTrace":
        with open(path) as f:
            return cls.from_json(f.read())


def stream_seed(segment_seed: int, stream_id: str) -> int:
    """Stable per-(segment, stream) scene seed.  ``zlib.crc32`` rather than
    ``hash()`` — the builtin is salted per interpreter run and would break
    bit-reproducibility."""
    return (segment_seed * 131 + zlib.crc32(stream_id.encode())) & _SEED_MASK


def draw_scenario(rng, mix: Mapping[str, float]) -> str:
    """One seeded draw from a (possibly unnormalized) scenario mix, in
    sorted-key order so the draw is independent of dict insertion order."""
    items = sorted(mix.items())
    total = sum(w for _, w in items)
    u = rng.random() * total
    acc = 0.0
    for name, w in items:
        acc += w
        if u < acc:
            return name
    return items[-1][0]


def compile_trace(episode: Episode, seed: int, tick_scale: float = 1.0) -> ScenarioTrace:
    """Compile an ``Episode`` into a ``ScenarioTrace``.

    Each phase becomes ``split`` piecewise-linear segments: ramp endpoints
    are the phase ramp evaluated at the chunk boundaries, timestamps are
    cumulative on the tick period, and every segment receives a derived
    sub-seed (mixed from ``seed`` and the segment index).  ``tick_scale``
    shrinks or stretches every phase's tick count (CI smoke replays at
    half scale; benchmarks can stretch) without changing the segment
    structure — the structure is a pure function of the spec, which is
    what the cross-seed property test relies on.
    """
    if tick_scale <= 0:
        raise ValueError(f"tick_scale must be positive, got {tick_scale}")
    segments: list[Segment] = []
    t = 0.0
    idx = 0
    for phase in episode.phases:
        total = max(int(round(phase.ticks * tick_scale)), phase.split)
        base, rem = divmod(total, phase.split)
        offset = 0
        for j in range(phase.split):
            n = base + (1 if j < rem else 0)
            a = offset / total
            b = (offset + n) / total
            seg = Segment(
                label=phase.label if phase.split == 1 else f"{phase.label}/{j}",
                t_start=round(t, 9),
                n_ticks=n,
                scenario_mix=_check_mix(phase.scenario_mix),
                rain=(_lerp(*phase.rain, a), _lerp(*phase.rain, b)),
                dropout=_check_dropout(phase.dropout),
                contention=(_lerp(*phase.contention, a), _lerp(*phase.contention, b)),
                budget_scale=(_lerp(*phase.budget_scale, a), _lerp(*phase.budget_scale, b)),
                join=phase.join if j == 0 else (),
                leave=phase.leave if j == 0 else (),
                seed=(seed * 1_000_003 + idx * 7919 + 17) & _SEED_MASK,
            )
            segments.append(seg)
            offset += n
            t += n * episode.period_s
            idx += 1
    return ScenarioTrace(
        name=episode.name,
        seed=seed,
        period_s=episode.period_s,
        budget_s=episode.budget_s,
        streams=episode.streams,
        segments=segments,
    )
