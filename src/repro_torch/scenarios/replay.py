"""Deterministic scenario replay through the full batched perception
stack, emitting per-segment ``VariationReport``s.

``ScenarioReplayer`` drives ``RungBucketScheduler`` (one
``BatchedPerceptionEngine`` per rung + per-stream anytime contract
controllers over a shared ``LadderCostModel``) through a compiled
``ScenarioTrace``:

* **virtual time** — the control path runs under ``SimClock``: measured
  wall-clock stage durations are replaced by ``ModeledStageCost``, a
  seeded per-(rung, stage, batch-size, work) latency model, and the clock
  advances by each bucket's modeled step.  Two replays of the same trace
  and seed therefore produce **byte-identical** report JSON — wall time
  never touches a decision, a latency, or a statistic.
* **real compute** — scenes are still generated and pushed through the
  real batched pipelines (one CUDA graph per rung engine on the card),
  because detections feed the quality scores, proposal counts drive the
  modeled post time (the paper's Insight 3 mechanism), and fusion
  consumes real per-stream outputs.
* **per-segment accounting** — each segment reports per-stream p50/p99,
  CV, miss rate and the rung histogram, plus fusion loss from an
  ``ApproxTimeSynchronizer`` over the segment's seated cameras.

The replay ladder uses *fixed* calibration constants
(``DEFAULT_LADDER_SPECS``) rather than a measured ``calibrate()`` run:
measured stage means differ per host and would leak wall-clock variation
into the modeled costs, breaking golden fixtures.

This is the port of the reference's ``repro/scenarios/replay.py``: the
same randomness is drawn in the same order (one NumPy generator for the
dropout, scenario and shutter-stagger draws of each stream and tick, and
the cost model's own generator once per modeled stage), so a replay on
the reference's detector weights gives the reference's report.  Weights
come from ``params=`` (pipeline name → NumPy tree) or ``generator=``.
``chaos=`` takes a compiled ``repro_torch.chaos.FaultPlan``; ``mesh=`` a
``repro_torch.launch.mesh.Mesh`` for a multi-shard fleet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from ..anytime.controller import ControllerConfig
from ..anytime.ladder import Ladder, Rung
from ..batched.scheduler import RungBucketScheduler
from ..bus.clock import SimClock
from ..core.stats import json_num
from ..obs.attribution import FrameSample
from ..perception.data import SceneConfig, generate_scene
from ..perception.fusion import ApproxTimeSynchronizer

from .trace import ScenarioTrace, draw_scenario, stream_seed

__all__ = [
    "DEFAULT_LADDER_SPECS",
    "replay_ladder",
    "ModeledStageCost",
    "StreamSegmentStats",
    "SegmentReport",
    "VariationReport",
    "ScenarioReplayer",
]

# Fixed per-rung calibration constants (seconds / quality in [0,1]) —
# magnitudes follow a CPU calibrate() run of the same rungs, frozen so
# modeled costs are host-independent.  two_stage is post-dominated (the
# paper's dynamic-shape pipeline), the λ/early-exit rungs are cheap and
# static.
DEFAULT_LADDER_SPECS: dict[str, dict] = {
    "two_stage": dict(
        pipeline="two_stage", scale=1.0, quality=0.85,
        stage_means={"read": 0.0004, "inference": 0.0022,
                     "post_processing": 0.0028}),
    "one_stage": dict(
        pipeline="one_stage", scale=1.0, quality=0.70,
        stage_means={"read": 0.0004, "inference": 0.0016,
                     "post_processing": 0.0007}),
    "early_exit@0.5": dict(
        pipeline="early_exit", scale=0.5, quality=0.45,
        stage_means={"read": 0.0003, "inference": 0.0007,
                     "post_processing": 0.0003}),
}


def replay_ladder(names: Optional[Sequence[str]] = None) -> Ladder:
    """The deterministic replay ladder: rungs with frozen stage means and
    qualities (no wall-clock calibration), best quality first."""
    names = list(names) if names is not None else list(DEFAULT_LADDER_SPECS)
    rungs = []
    for n in names:
        spec = DEFAULT_LADDER_SPECS[n]
        rungs.append(Rung(n, spec["pipeline"], spec["scale"],
                          quality=spec["quality"],
                          stage_means=dict(spec["stage_means"])))
    rungs.sort(key=lambda r: r.quality, reverse=True)
    return Ladder(rungs)


class ModeledStageCost:
    """Seeded per-(rung, stage, batch-size, work) latency model.

    A batched step over ``n`` streams costs the rung's per-frame stage
    mean times an affine batch term (fixed dispatch cost plus per-slot
    work), a post-processing work term proportional to the tick's total
    proposal count (Insight 3: proposals drive post time), the current
    ``contention`` multiplier (set per tick by the replayer from the
    trace), and a lognormal jitter drawn from this model's own generator.
    Every draw comes from one seeded stream in deterministic tick order,
    which is what makes replay bit-reproducible.
    """

    def __init__(
        self,
        ladder: Ladder,
        seed: int,
        jitter: float = 0.06,
        batch_base: float = 0.6,
        batch_slope: float = 0.4,
        work_norm: float = 25.0,
    ) -> None:
        self.means = {r.name: dict(r.stage_means) for r in ladder}
        self.jitter = jitter
        self.batch_base = batch_base
        self.batch_slope = batch_slope
        self.work_norm = work_norm
        self.contention = 1.0
        self.rng = np.random.default_rng(seed)

    def __call__(self, rung: str, stage: str, batch_size: int,
                 work: float = 0.0) -> float:
        base = self.means[rung].get(stage, 0.0)
        if base <= 0.0:
            return 0.0
        step = base * (self.batch_base + self.batch_slope * batch_size)
        if stage == "post_processing":
            # unconditional, monotone in work: a zero-proposal tick sits at
            # the 0.7 floor, never above a denser tick's modeled post time
            step *= min(0.7 + 0.3 * work / (self.work_norm * max(batch_size, 1)),
                        2.5)
        step *= self.contention
        return float(step * self.rng.lognormal(0.0, self.jitter))


@dataclasses.dataclass
class StreamSegmentStats:
    """One stream's variation statistics within one segment."""

    frames: int
    drops: int
    misses: int
    p50_ms: Optional[float]
    p99_ms: Optional[float]
    cv: Optional[float]
    mean_quality: Optional[float]
    rungs: dict[str, int]

    def to_dict(self) -> dict:
        return {
            "frames": self.frames, "drops": self.drops, "misses": self.misses,
            "p50_ms": json_num(self.p50_ms) if self.p50_ms is not None else None,
            "p99_ms": json_num(self.p99_ms) if self.p99_ms is not None else None,
            "cv": json_num(self.cv) if self.cv is not None else None,
            "mean_quality": (json_num(self.mean_quality)
                             if self.mean_quality is not None else None),
            "rungs": dict(sorted(self.rungs.items())),
        }


@dataclasses.dataclass
class SegmentReport:
    """Variation statistics for one trace segment."""

    label: str
    t_start: float
    ticks: int
    frames: int
    drops: int
    misses: int
    p50_ms: Optional[float]
    p99_ms: Optional[float]
    cv: Optional[float]
    mean_quality: Optional[float]
    rung_hist: dict[str, int]
    streams: dict[str, StreamSegmentStats]
    fusion: dict

    @property
    def miss_rate(self) -> float:
        return self.misses / self.frames if self.frames else float("nan")

    def to_dict(self) -> dict:
        return {
            "label": self.label,
            "t_start": json_num(self.t_start),
            "ticks": self.ticks,
            "frames": self.frames,
            "drops": self.drops,
            "misses": self.misses,
            "miss_rate": json_num(self.miss_rate),
            "p50_ms": json_num(self.p50_ms) if self.p50_ms is not None else None,
            "p99_ms": json_num(self.p99_ms) if self.p99_ms is not None else None,
            "cv": json_num(self.cv) if self.cv is not None else None,
            "mean_quality": (json_num(self.mean_quality)
                             if self.mean_quality is not None else None),
            "rung_hist": dict(sorted(self.rung_hist.items())),
            "streams": {k: v.to_dict() for k, v in sorted(self.streams.items())},
            "fusion": self.fusion,
        }


@dataclasses.dataclass
class VariationReport:
    """The whole episode's replay outcome, segment by segment."""

    episode: str
    seed: int
    n_ticks: int
    clock_s: float
    segments: list[SegmentReport]
    # fault/recovery ledger dict when a chaos plan actually fired during
    # the replay; None (and absent from the JSON) otherwise — so a
    # fault-free run with chaos machinery attached serializes
    # byte-identically to a plain run
    chaos: Optional[dict] = None

    def totals(self) -> dict:
        frames = sum(s.frames for s in self.segments)
        misses = sum(s.misses for s in self.segments)
        drops = sum(s.drops for s in self.segments)
        hist: dict[str, int] = {}
        for s in self.segments:
            for r, n in s.rung_hist.items():
                hist[r] = hist.get(r, 0) + n
        return {
            "frames": frames,
            "drops": drops,
            "misses": misses,
            "miss_rate": json_num(misses / frames if frames else float("nan")),
            "fusion_dropped": sum(s.fusion["dropped"] for s in self.segments),
            "fusion_stranded": sum(s.fusion["stranded"] for s in self.segments),
            "rung_hist": dict(sorted(hist.items())),
        }

    def to_dict(self) -> dict:
        d = {
            "episode": self.episode,
            "seed": self.seed,
            "n_ticks": self.n_ticks,
            "clock_s": json_num(self.clock_s),
            "totals": self.totals(),
            "segments": [s.to_dict() for s in self.segments],
        }
        if self.chaos:
            d["chaos"] = self.chaos
        return d

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent,
                          separators=(",", ": ") if indent else (",", ":"))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2) + "\n")


class ScenarioReplayer:
    """Replay one ``ScenarioTrace`` through the batched stack.

    Pass ``scheduler=`` to reuse a previous replayer's scheduler (see
    ``.scheduler``): it is reset to fresh-run state but keeps its built
    engines, so a suite of episodes captures each rung's CUDA graph once.
    A reused scheduler must have been built on the same ladder and enough
    capacity for this trace's peak stream count.

    A scheduler built here takes its detector weights from ``params``
    (pipeline name → reference NumPy tree, as ``build_pipeline`` takes
    them) or else from ``generator`` (seed 7 when none is given), and runs
    on ``device`` (the card unless ``"cpu"`` is asked for).

    ``depth`` is the pipelined-executor wiring: replay always **falls
    back to the synchronous depth-1 path** regardless of the requested
    depth, because byte-reproducible reports are defined on sync ticks —
    a modeled ``SimClock`` cannot observe real dispatch overlap, and the
    golden fixtures are contracts on the sync engine.  The requested
    value is kept on ``.requested_depth`` so a wall-clock harness can
    drive the same trace pipelined.

    ``chaos=`` takes a compiled ``repro_torch.chaos.FaultPlan``: it wires
    the injector (pure plan lookups) and the scheduler's resilience layer
    (health machines, watchdog, retry) into the replay.

    ``mesh=`` (a ``repro_torch.launch.mesh.Mesh``) makes a fleet replay: a
    scheduler built here shards every rung engine's slot batch over the
    mesh's data axis.  On a one-shard mesh the placer and the sharded cost
    model are bypassed (``n_shards == 1``), so the report is byte-identical
    to the meshless one.  A reused scheduler keeps the mesh it was built
    with.
    """

    def __init__(
        self,
        trace: ScenarioTrace,
        ladder: Optional[Ladder] = None,
        scheduler: Optional[RungBucketScheduler] = None,
        capacity: Optional[int] = None,
        ctl_cfg: Optional[ControllerConfig] = None,
        generator: Optional[torch.Generator] = None,
        params: Optional[Mapping[str, Any]] = None,
        fusion_queue: int = 4,
        jitter: float = 0.06,
        depth: int = 1,
        obs=None,
        mesh=None,
        chaos=None,
        device: str | torch.device | None = None,
    ) -> None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1 (got {depth})")
        self.requested_depth = depth
        self.depth = 1                 # sync fallback: see class docstring
        self.trace = trace
        need = trace.max_concurrent_streams()
        self.clock = SimClock()
        if scheduler is None:
            cap = capacity if capacity is not None else need
            if cap < need:
                raise ValueError(
                    f"capacity {cap} < peak stream count {need} of trace "
                    f"{trace.name!r}")
            ladder = ladder if ladder is not None else replay_ladder()
            self.cost = ModeledStageCost(ladder, seed=trace.seed, jitter=jitter)
            scheduler = RungBucketScheduler(
                ladder, capacity=cap, generator=generator, ctl_cfg=ctl_cfg,
                clock=self.clock, stage_cost=self.cost, depth=self.depth,
                device=device if device is not None else "cuda", params=params, mesh=mesh)
        else:
            # a reused scheduler brings its own ladder/controller config/
            # weights/device — accepting overrides here would silently
            # produce a report under a different configuration than requested
            if (ladder is not None or generator is not None or params is not None
                    or ctl_cfg is not None or device is not None or mesh is not None):
                raise ValueError(
                    "scheduler was passed already built; ladder/ctl_cfg/"
                    "generator/params/device/mesh belong to its construction "
                    "and would be silently ignored here")
            if capacity is not None and capacity != scheduler.capacity:
                raise ValueError(
                    f"reused scheduler has capacity {scheduler.capacity}, "
                    f"not the requested {capacity}")
            if scheduler.capacity < need:
                raise ValueError(
                    f"reused scheduler capacity {scheduler.capacity} < peak "
                    f"stream count {need} of trace {trace.name!r}")
            if scheduler.depth != 1:
                raise ValueError(
                    "reused scheduler must be depth-1: replay determinism "
                    "is defined on the synchronous engine path")
            self.cost = ModeledStageCost(scheduler.ladder, seed=trace.seed,
                                         jitter=jitter)
            scheduler.reset()
            scheduler.set_virtual(self.clock, self.cost)
        self.scheduler = scheduler
        self.fusion_queue = fusion_queue
        # observability: bind the observatory to this episode's SimClock
        # (spans land on the virtual timeline, so traces are byte-
        # reproducible too) and tag each rung engine's span stream with
        # the episode name.  Attaching an observatory is pure observation:
        # it reads the clock and copies row fields, so the report stays
        # byte-identical with tracing on.
        self.obs = obs
        scheduler.set_obs(obs)
        if obs is not None:
            obs.bind_clock(self.clock)
            for rung_name, eng in scheduler.engines.items():
                eng.obs_tag = f"{trace.name}/{rung_name}"
        # chaos: all fault randomness was spent at plan compile time, so an
        # empty plan makes this attachment pure observation.  Imports are
        # lazy: repro_torch.chaos.catalog builds replayers, so a
        # module-level import here would be circular.
        self.injector = None
        self.resilience = None
        if chaos is not None:
            from ..chaos.inject import FaultInjector
            from ..chaos.ledger import ChaosLedger
            from ..chaos.recovery import FleetResilience
            ledger = ChaosLedger(obs=obs)
            self.resilience = FleetResilience(ledger=ledger)
            self.injector = FaultInjector(chaos, ledger=ledger)
            scheduler.attach_resilience(self.resilience)

    def run(self, sentinel=None) -> VariationReport:
        """Replay the episode.  ``sentinel`` (a
        ``repro_torch.analysis.TraceSentinel``, or any context manager)
        guards the steady-state segment loop only: the warm-up (every rung
        engine's step built, on the card its CUDA graph captured, and the
        cost model seeded) happens before it is entered, so a default
        sentinel (compile budget 0, transfer_guard "disallow") asserts that
        no tick builds a step anew and no host synchronisation hides in the
        per-tick path.  A sentinel without a tracer gets the observatory's,
        so builds it sees land on the episode's timeline.  A sentinel
        changes no data flow — reports stay byte-identical with or without
        it."""
        tr = self.trace
        sched = self.scheduler
        # build + seed the shared cost model (modeled probes: offline,
        # clock untouched) before the episode's first frame
        sched.warm(SceneConfig(scenario="city", seed=tr.seed & 0xFFFF))
        for sid in tr.streams:
            sched.add_stream(sid, tr.budget_s)

        rng = np.random.default_rng((tr.seed * 2_147_483_629 + 0x5EED) & 0x7FFFFFFF)
        if (sentinel is not None and self.obs is not None
                and getattr(sentinel, "tracer", None) is None):
            # builds observed by the sentinel land in the episode timeline
            # as runtime-axis spans
            sentinel.tracer = self.obs.tracer
        guard = sentinel if sentinel is not None else contextlib.nullcontext()
        with guard:
            reports = self._run_segments(tr, sched, rng)
        report = VariationReport(
            episode=tr.name, seed=tr.seed, n_ticks=tr.n_ticks,
            clock_s=self.clock.time(), segments=reports)
        if self.injector is not None and len(self.injector.ledger):
            report.chaos = self.injector.ledger.to_dict()
        return report

    def _run_segments(self, tr, sched, rng) -> list[SegmentReport]:
        reports: list[SegmentReport] = []
        tick_idx = 0
        for seg in tr.segments:
            for sid in seg.leave:
                sched.remove_stream(sid)
            for sid in seg.join:
                sched.add_stream(sid, tr.budget_s)
            active = sorted(sched.streams)
            sync = ApproxTimeSynchronizer(
                active, queue_size=self.fusion_queue, slop=0.45 * tr.period_s)
            rows: list[dict] = []
            # lazily keyed: seeding from segment-start ``active`` would
            # KeyError on churn edge cases (a stream seated after the
            # snapshot, e.g. leave+rejoin inside one segment) and silently
            # pins accounting to a stale membership view
            drops: dict[str, int] = {}
            for k in range(seg.n_ticks):
                self.cost.contention = seg.contention_at(k)
                if self.injector is not None:
                    # adversarial latency spike: compounds with the
                    # trace's own contention profile
                    self.cost.contention *= self.injector.latency_scale(tick_idx)
                rain = seg.rain_at(k)
                budget = tr.budget_s * seg.budget_scale_at(k)
                t0 = self.clock.time()
                scenes = {}
                stamps = {}
                for sid in active:
                    if rng.random() < seg.dropout_for(sid):
                        drops[sid] = drops.get(sid, 0) + 1
                        continue
                    cfg = SceneConfig(
                        scenario=draw_scenario(rng, seg.scenario_mix),
                        rain_mm_per_hour=rain,
                        seed=stream_seed(seg.seed, sid))
                    scenes[sid] = generate_scene(cfg, tick_idx)
                    # camera shutters are not perfectly synchronized:
                    # stagger capture stamps across a fraction of the
                    # period *before* the tick processes them, so fusion's
                    # slop matching is exercised and delays (arrival −
                    # stamp) stay physically non-negative
                    stamps[sid] = t0 - 0.25 * tr.period_s * rng.random()
                if self.injector is not None:
                    # infrastructure faults first (shard kills/revives,
                    # armed step failures), then sensor faults — AFTER
                    # scene generation, so the dropout/scenario RNG
                    # consumes draws in exactly the fault-free order
                    self.injector.pre_tick(tick_idx, sched)
                    scenes = self.injector.filter_scenes(tick_idx, scenes)
                # tick even when every stream dropped: the scheduler's
                # per-stream dropout accounting must see the empty tick
                res = sched.tick(
                    scenes, budgets={sid: budget for sid in scenes})
                rows.extend(res.rows)
                if self.obs is not None:
                    # the replayer is the one component that knows the
                    # injected contention level, so it builds the
                    # attribution samples (hardware-axis grouping feature)
                    for r in res.rows:
                        self.obs.sample(FrameSample(
                            latency_s=r["latency_s"], stream=r["stream"],
                            tick=r["tick"], segment=seg.label,
                            scenario=r["scenario"], rung=r["rung"],
                            batch_size=r["batch_size"],
                            work=int(r["work"]),
                            contention=self.cost.contention))
                now = self.clock.time()
                for sid in scenes:
                    sync.add(sid, stamps[sid], None, now)
                # idle out the rest of the frame period in virtual time
                self.clock.advance_to(t0 + tr.period_s)
                tick_idx += 1
            reports.append(self._segment_report(seg, active, rows, drops, sync))
        return reports

    @staticmethod
    def _segment_report(seg, active, rows, drops, sync) -> SegmentReport:
        def stats(lats):
            if not lats:
                return None, None, None
            arr = np.asarray(lats, float)
            mu = float(arr.mean())
            cv = float(arr.std() / mu) if mu > 0 else float("nan")
            return (float(np.percentile(arr, 50)) * 1e3,
                    float(np.percentile(arr, 99)) * 1e3, cv)

        per_stream: dict[str, StreamSegmentStats] = {}
        seg_lats: list[float] = []
        seg_hist: dict[str, int] = {}
        seg_misses = 0
        seg_quals: list[float] = []
        for sid in active:
            mine = [r for r in rows if r["stream"] == sid]
            lats = [r["latency_s"] for r in mine]
            quals = [r["quality"] for r in mine if r["quality"] is not None]
            rungs: dict[str, int] = {}
            for r in mine:
                rungs[r["rung"]] = rungs.get(r["rung"], 0) + 1
                seg_hist[r["rung"]] = seg_hist.get(r["rung"], 0) + 1
            misses = sum(int(r["miss"]) for r in mine)
            p50, p99, cv = stats(lats)
            per_stream[sid] = StreamSegmentStats(
                frames=len(mine), drops=drops.get(sid, 0), misses=misses,
                p50_ms=p50, p99_ms=p99, cv=cv,
                mean_quality=float(np.mean(quals)) if quals else None,
                rungs=rungs)
            seg_lats.extend(lats)
            seg_misses += misses
            seg_quals.extend(quals)
        p50, p99, cv = stats(seg_lats)
        delays = sync.delays()
        return SegmentReport(
            label=seg.label, t_start=seg.t_start, ticks=seg.n_ticks,
            frames=len(rows), drops=sum(drops.values()), misses=seg_misses,
            p50_ms=p50, p99_ms=p99, cv=cv,
            mean_quality=float(np.mean(seg_quals)) if seg_quals else None,
            rung_hist=seg_hist, streams=per_stream,
            fusion={
                "events": len(sync.events),
                "dropped": sync.dropped,
                "dropped_overflow": sync.dropped_overflow,
                "dropped_sweep": sync.dropped_sweep,
                # messages still queued when the segment's synchronizer is
                # torn down never fused: count them, or a dropout segment
                # shorter than the queue depth reports zero fusion loss
                "stranded": sum(len(q) for q in sync.queues.values()),
                "mean_delay_ms": json_num(float(np.mean(delays)) * 1e3
                                      if delays else float("nan")),
            })
