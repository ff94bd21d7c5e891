"""Rung-bucketed frame scheduler: anytime fidelity control over the batched
multi-camera engine (the port of the reference's
``repro/batched/scheduler.py``).

Each tick, every stream's contract controller picks the rung that fits
its residual deadline; streams that chose the same rung share one batched
device step (one engine per rung, all at full stream capacity, so bucket
migration never changes a captured shape: one CUDA graph per rung).  The
shared ``LadderCostModel`` learns per-(rung, batch-size) latency —
``SceneFeatures.batch_size`` — so the controller's residual-deadline
decision accounts for batching delay: a rung that fits alone may not fit
when seven co-residents share its bucket, and the model sees exactly that.

Batch size is a pre-execution feature with the same temporal-coherence
argument the cost model already uses for proposal counts: a stream's
expected co-batch size next tick is approximated by its current rung's
bucket size last tick (pessimistically, all active streams before any
history).

**Fleet sharding** (``mesh=``): every rung engine splits its slot batch
over the mesh's data axis; a joining stream is seated by the
``FleetPlacer`` on the shard whose predicted post-seating cost is
smallest, and after each tick one stream of a skewed rung engine migrates
toward balance (``_rebalance_shards``).  Both are slot churn only: no new
capture, ever.  On one shard (no mesh, or a data axis of 1) the placer and
the rebalance are bypassed and the scheduler is the single-device one.

The chaos/recovery hooks: ``attach_resilience``, ``kill_shard`` (every
stream on the lost shard is evacuated onto an alive shard with a free
slot; a victim with none — at one shard, every victim — is unseated,
force-degraded and re-seated by a later tick's join), ``revive_shard``,
the ingest guard, the retry gate and the watchdog.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..anytime.controller import ContractController, ControllerConfig
from ..anytime.cost import LadderCostModel, SceneFeatures
from ..anytime.ladder import Ladder, frame_quality
from ..bus.clock import SimClock
from ..core.stats import json_num
from ..distributed.sharding import data_shards
from ..perception.data import Scene, SceneConfig, generate_scene
from ..perception.pipelines import build_pipeline

from .engine import BatchedPerceptionEngine
from .fleet import FleetPlacer

__all__ = ["ScheduledStream", "TickResult", "RungBucketScheduler"]


@dataclasses.dataclass
class ScheduledStream:
    """One camera stream under scheduling: its contract controller (rung
    hysteresis is per stream) plus running accounting."""

    stream_id: str
    budget_s: float
    controller: ContractController
    prev_proposals: Optional[float] = None
    frames: int = 0
    misses: int = 0
    drops: int = 0            # seated ticks with no frame (sensor dropout)
    qualities: list = dataclasses.field(default_factory=list)
    latencies: list = dataclasses.field(default_factory=list)

    @property
    def miss_rate(self) -> float:
        return self.misses / self.frames if self.frames else float("nan")


@dataclasses.dataclass(frozen=True)
class TickResult:
    """One tick's outcome: which rung served which bucket, per stream."""

    buckets: Dict[str, list]          # rung name -> [stream ids]
    latencies: Dict[str, float]       # rung name -> batched step latency
    outputs: Dict[str, object]        # stream id -> FrameOutput
    rows: list                        # per-stream dict rows
    # fleet mode only: rung name -> shard id -> [stream ids] (empty on one
    # shard, where seat location carries no cost signal)
    shard_buckets: Dict[str, Dict[int, list]] = dataclasses.field(default_factory=dict)


class RungBucketScheduler:
    """Groups streams by their controller-chosen rung each tick and serves
    every bucket with one batched step.

    ``params`` maps pipeline names to reference parameter trees of NumPy
    arrays (as ``build_pipeline`` takes them); pipelines without an entry
    draw their weights from ``generator`` (seed 7 when none is given).
    ``device`` defaults to the card and raises without one unless ``"cpu"``
    is asked for.  ``mesh`` (``repro_torch.launch.mesh.Mesh``) shards every
    rung engine's slot batch over its data axis (module docstring)."""

    def __init__(
        self,
        ladder: Ladder,
        capacity: int = 8,
        generator: Optional[torch.Generator] = None,
        ctl_cfg: Optional[ControllerConfig] = None,
        clock: Optional[SimClock] = None,
        stage_cost: Optional[Callable[[str, str, int, float], float]] = None,
        depth: int = 1,
        obs=None,
        device: str | torch.device = "cuda",
        params: Optional[Mapping[str, Any]] = None,
        mesh=None,
    ) -> None:
        if depth > 1 and stage_cost is not None:
            raise ValueError(
                "stage_cost (virtual-time replay) requires depth=1: replay "
                "determinism is defined on the synchronous engine path"
            )
        self.ladder = ladder
        self.capacity = capacity
        self.ctl_cfg = ctl_cfg if ctl_cfg is not None else ControllerConfig()
        self.depth = depth
        # fleet sharding: every rung engine partitions its padded slot batch
        # over the mesh's data axis; the placer seats joining streams on
        # shards by predicted (rung, batch-size) cost
        self.mesh = mesh
        self.n_shards = data_shards(mesh)
        # one cost model shared by every stream: latency is a property of
        # the shared accelerator, not of any one camera
        self.cost = LadderCostModel(ladder)
        self.placer = FleetPlacer(self.cost, self.n_shards, pipeline_depth=depth)
        # one engine per rung, all at full capacity: any bucket split can
        # be seated and membership churn never changes a captured shape
        self.engines: Dict[str, BatchedPerceptionEngine] = {}
        for rung in ladder:
            tree = params.get(rung.pipeline) if params is not None else None
            built = build_pipeline(rung.pipeline, scale=rung.scale, generator=generator,
                                   pad=False, device=device, params=tree)
            self.engines[rung.name] = BatchedPerceptionEngine(built, capacity=capacity,
                                                              depth=depth, mesh=mesh)
        self.streams: Dict[str, ScheduledStream] = {}
        self._last_bucket_size: Dict[str, int] = {}
        self._prev_rung: Dict[str, str] = {}
        self.ticks = 0
        self.clock = None
        self.stage_cost = None
        self.obs = None
        # chaos/recovery: a ``repro_torch.chaos.FleetResilience`` (duck
        # typed — the scheduler never imports chaos, so the dependency
        # points one way).  None means every recovery path is inert.
        self.resilience = None
        # streams unseated by a shard evacuation: the normal tick join path
        # re-seats them, and that join is ledgered as the completing failover
        self._pending_reseat: set = set()
        self.set_virtual(clock, stage_cost)
        self.set_obs(obs)

    def set_obs(self, obs) -> None:
        """Attach/detach a ``repro_torch.obs.Observatory`` (pass None to
        detach).  Every rung engine emits its tick spans to it, tagged with
        the rung name; the scheduler itself emits ``rung_switch`` instants
        when a stream's controller migrates buckets."""
        self.obs = obs
        for rung_name, eng in self.engines.items():
            eng.obs = obs
            eng.obs_tag = rung_name

    def set_virtual(
        self,
        clock: Optional[SimClock],
        stage_cost: Optional[Callable[[str, str, int, float], float]] = None,
    ) -> None:
        """(Re)wire virtual-time replay: every rung engine gets the shared
        ``clock`` and a rung-bound view of ``stage_cost(rung, stage,
        batch_size, work)``.  All engines share one clock, so a tick's
        bucket steps advance virtual time sequentially — one accelerator.
        Pass ``(None, None)`` to return to measured wall-clock timing."""
        if stage_cost is not None and self.depth > 1:
            raise ValueError("stage_cost (virtual-time replay) requires depth=1 engines")
        self.clock = clock
        self.stage_cost = stage_cost
        for rung_name, eng in self.engines.items():
            eng.clock = clock
            if stage_cost is None:
                eng.stage_cost = None
            else:
                eng.stage_cost = (
                    lambda stage, batch, work=0.0, _r=rung_name: stage_cost(_r, stage, batch, work))

    def reset(self) -> None:
        """Forget every stream, all accounting, and all learned cost state,
        keeping the engines' captured steps — so one scheduler replays many
        episodes with fresh-controller determinism and no new capture."""
        self.streams.clear()
        self._last_bucket_size.clear()
        self._prev_rung.clear()
        self.ticks = 0
        self.cost = LadderCostModel(self.ladder)
        self.placer = FleetPlacer(self.cost, self.n_shards, pipeline_depth=self.depth)
        # resilience is per-episode state (health machines, armed faults):
        # a reused scheduler must not leak one episode's quarantines into
        # the next — the replayer re-attaches a fresh instance when asked
        self.resilience = None
        self._pending_reseat.clear()
        for eng in self.engines.values():
            eng.reset()

    def attach_resilience(self, res) -> None:
        """Attach a ``FleetResilience`` (None detaches).  With it attached
        the scheduler gains its failure paths: NaN-frame quarantine at
        ingest, bounded retry of transient step faults, a latency watchdog
        that forces rung degrades, and survivable shard evacuation."""
        self.resilience = res
        self._pending_reseat.clear()

    def warm(self, probe_cfg: Optional[SceneConfig] = None) -> None:
        """Build every rung's batched step up front and seed the cost model
        with one measured full-capacity probe per rung.  Without the probe,
        an unobserved rung's batched prediction stays at the pessimistic
        serial bound and the controller could never judge an upgrade into
        that rung's bucket to fit.  The probe runs on ``probe_cfg`` synthetic
        scenes, not blank buffers, so rungs with data-dependent
        post-processing (two_stage) seed a representative cost."""
        if probe_cfg is None:
            probe_cfg = SceneConfig()
        frames = [generate_scene(probe_cfg, i).image for i in range(self.capacity)]
        for rung_name, eng in self.engines.items():
            rec = eng.probe(frames)
            if self.depth > 1:
                # a probe is a blocking synchronous step; seeding the
                # completion-latency regression with it verbatim would flip
                # the model off the depth-aware prior and under-estimate
                # pipe residence.  Seed measured step cost x residence.
                rec.meta["frame_latency_s"] = rec.end_to_end * self.depth
            self.cost.observe(
                rung_name, rec,
                SceneFeatures(batch_size=float(self.capacity), batched=True,
                              pipeline_depth=float(self.depth)))

    # ---------------- stream membership ----------------
    def add_stream(self, stream_id: str, budget_s: float) -> ScheduledStream:
        if stream_id in self.streams:
            raise ValueError(f"stream {stream_id!r} already exists")
        if len(self.streams) >= self.capacity:
            raise RuntimeError(f"scheduler at capacity ({self.capacity} streams)")
        st = ScheduledStream(
            stream_id=stream_id, budget_s=budget_s,
            controller=ContractController(self.ladder, cost=self.cost, cfg=self.ctl_cfg),
        )
        self.streams[stream_id] = st
        return st

    def remove_stream(self, stream_id: str) -> ScheduledStream:
        st = self.streams.pop(stream_id)
        self._pending_reseat.discard(stream_id)
        for eng in self.engines.values():
            if stream_id in eng.active:
                eng.leave(stream_id)
        return st

    # ---------------- shard failure / recovery ----------------
    def kill_shard(self, shard: int) -> None:
        """Declare ``shard`` lost and evacuate every stream seated on it.

        Evacuation is pure slot churn via ``engine.migrate`` — captured
        shapes never change, so failover never captures anew.  A victim
        with no alive shard to move to — on one shard, every victim — is
        unseated instead, its controller force-degraded (capacity pressure:
        it re-enters at lower fidelity), and queued on ``_pending_reseat``
        for the normal join path to re-seat once capacity returns.  A shard
        out of range raises ``ValueError`` (``FleetPlacer.mark_dead``)."""
        res = self.resilience
        self.placer.mark_dead(shard)
        for rung_name in sorted(self.engines):
            eng = self.engines[rung_name]
            for sid in eng.streams_on(shard):
                try:
                    dst = self.placer.place(rung_name, eng.shard_occupancy(),
                                            eng.slots_per_shard)
                except RuntimeError:
                    eng.leave(sid)
                    self._pending_reseat.add(sid)
                    st = self.streams.get(sid)
                    if st is not None:
                        st.controller.force_degrade()
                    if res is not None:
                        res.ledger.add(
                            self.ticks, "degrade",
                            f"evacuation capacity pressure: unseated from shard {shard}",
                            stream=sid, shard=shard)
                    continue
                eng.migrate(sid, dst)
                if res is not None:
                    res.ledger.add(self.ticks, "failover",
                                   f"evacuated {rung_name} stream from shard {shard}",
                                   stream=sid, shard=dst)

    def revive_shard(self, shard: int) -> None:
        """Return ``shard`` to the placement pool.  Streams drift back via
        the normal per-tick skew rebalance — no eager mass migration, so
        recovery has the same one-move-per-tick churn bound as any other
        imbalance."""
        self.placer.mark_alive(shard)

    # ---------------- the tick ----------------
    def _features(self, st: ScheduledStream, scene: Scene) -> SceneFeatures:
        rung = st.controller.current.name
        return SceneFeatures(
            proposals_prev=st.prev_proposals,
            rain_mm_per_hour=scene.rain,
            scenario=scene.scenario,
            batch_size=float(self._last_bucket_size.get(rung, max(len(self.streams), 1))),
            # always the batched cost route: even a singleton bucket pays
            # a full capacity-wide padded step
            batched=True,
            # pipelined engines complete a frame depth-1 ticks after its
            # submission; the cost model scales tails accordingly
            pipeline_depth=float(self.depth),
        )

    def tick(self, scenes: Mapping[str, Scene],
             budgets: Optional[Mapping[str, float]] = None) -> TickResult:
        """Serve one frame for every stream in ``scenes``.

        ``budgets`` overrides per-stream residual budgets for this tick
        (contention injection, as in ``run_anytime``'s ``budget_fn``).

        With pipelined engines (``depth >= 2``) a tick's results belong to
        the frames submitted ``depth-1`` ticks earlier; each submission
        carries its scenes and budgets as an echoed payload, so quality and
        deadline accounting always pair a result with the scene that
        produced it.  Buckets whose engine is still filling contribute no
        rows this tick; engines whose bucket emptied (all members migrated
        away) are flushed so no frame is lost in the pipe.
        """
        unknown = set(scenes) - set(self.streams)
        if unknown:
            raise KeyError(f"scenes for unknown streams: {sorted(unknown)}")

        # chaos/recovery ingest guard: quarantined streams are skipped,
        # non-finite frame payloads are dropped and fault-counted — on the
        # host images, before any frame is staged for the device.  With no
        # resilience attached (or a healthy fleet) the tick below is
        # unchanged.
        if self.resilience is not None:
            scenes = self._guard_ingest(scenes)

        # dropout-aware: a seated stream with no frame this tick is a
        # dropped sensor frame, not an error — count it, serve the rest
        for sid, st in self.streams.items():
            if sid not in scenes:
                st.drops += 1

        # 1. every stream picks its rung for this tick
        buckets: Dict[str, list[str]] = {}
        for sid, scene in scenes.items():
            st = self.streams[sid]
            budget = budgets[sid] if budgets is not None else st.budget_s
            sel = st.controller.select(budget, self._features(st, scene))
            rung_name = sel.rung.name
            if self.obs is not None:
                prev = self._prev_rung.get(sid)
                if prev is not None and prev != rung_name:
                    self.obs.tracer.instant("rung_switch", stream=sid, tick=self.ticks,
                                            rung=rung_name, axis="model")
                self._prev_rung[sid] = rung_name
            buckets.setdefault(rung_name, []).append(sid)

        # 2. serve each bucket with one batched step
        latencies: Dict[str, float] = {}
        outputs: Dict[str, object] = {}
        rows: list[dict] = []
        shard_buckets: Dict[str, Dict[int, list]] = {}
        for rung_name in list(buckets):
            members = buckets[rung_name]
            eng = self.engines[rung_name]
            # migrate membership: leave streams that moved away, join the
            # ones that moved in (slot churn only — never a new capture)
            for sid in [s for s in eng.active if s not in members]:
                eng.leave(sid)
            unseatable: list[str] = []
            for sid in members:
                if sid not in eng.active:
                    shard = None
                    if self.n_shards > 1:
                        # fleet placement: seat on the shard whose
                        # post-seating predicted cost is smallest
                        try:
                            shard = self.placer.place(rung_name, eng.shard_occupancy(),
                                                      eng.slots_per_shard)
                        except RuntimeError:
                            if self.resilience is None:
                                raise
                            # no alive capacity: survivable under chaos — the
                            # stream's frame drops this tick and the join
                            # retries next tick
                            self.streams[sid].drops += 1
                            unseatable.append(sid)
                            continue
                    eng.join(sid, shard=shard)
                    if sid in self._pending_reseat and self.resilience is not None:
                        # the deferred half of a shard evacuation lands
                        self._pending_reseat.discard(sid)
                        self.resilience.ledger.add(
                            self.ticks, "failover",
                            "re-seated after evacuation capacity pressure", stream=sid,
                            shard=shard if shard is not None else -1)
            if unseatable:
                members = [s for s in members if s not in unseatable]
                buckets[rung_name] = members
                if not members:
                    continue
            # transient step faults: the resilience layer arms N failures;
            # each bucket step retries through them with exponential
            # backoff, aborting (the bucket drops one tick) past max_retries
            if self.resilience is not None and self.resilience.armed:
                if not self._retry_gate(rung_name):
                    for sid in members:
                        self.streams[sid].drops += 1
                    buckets[rung_name] = []
                    continue
            if self.n_shards > 1:
                per: Dict[int, list] = {}
                for sid in members:
                    per.setdefault(eng.shard_of(sid), []).append(sid)
                shard_buckets[rung_name] = per
            payload = {
                sid: (scenes[sid], budgets[sid] if budgets is not None
                      else self.streams[sid].budget_s)
                for sid in members}
            record, outs, echoed = eng.tick({sid: scenes[sid].image for sid in members},
                                            payload=payload)
            self._last_bucket_size[rung_name] = len(members)
            if record is not None:
                self._account_drain(rung_name, record, outs, echoed, latencies, outputs, rows)

        # 3. retire in-flight work of engines that got no submissions
        # this tick (their streams all migrated, dropped, or left)
        for rung_name, eng in self.engines.items():
            if rung_name not in buckets and eng.in_flight:
                for record, outs, echoed in eng.flush():
                    self._account_drain(rung_name, record, outs, echoed, latencies, outputs,
                                        rows)

        # 4. watchdog: a served frame that blew past its deadline by the
        # watchdog factor is a wedged tick, not ordinary jitter — fault
        # the stream's health machine and force its rung down now
        if self.resilience is not None:
            self._watchdog(rows)

        # 5. cross-shard skew repair: when churn piles a rung's streams onto
        # one shard, every tick pays that shard's batch size while other
        # shards idle — migrate one stream toward balance
        if self.n_shards > 1:
            self._rebalance_shards(buckets)
        self.ticks += 1
        return TickResult(buckets=buckets, latencies=latencies, outputs=outputs, rows=rows,
                          shard_buckets=shard_buckets)

    # ---------------- chaos/recovery paths ----------------
    def _guard_ingest(self, scenes: Mapping[str, Scene]) -> Dict[str, Scene]:
        """Health-gate this tick's frames: age quarantine probations, skip
        quarantined streams, drop non-finite payloads (fault-counting the
        stream: repeated garbage escalates to quarantine).  Finiteness is
        read from the host NumPy image, so the guard costs no device
        synchronisation."""
        res = self.resilience
        for sid in res.age_quarantine(self.ticks):
            res.ledger.add(self.ticks, "probation",
                           "quarantine aged out: stream on probation", stream=sid)
        out: Dict[str, Scene] = {}
        for sid, scene in scenes.items():
            if res.is_quarantined(sid):
                res.ledger.add(self.ticks, "skip", "quarantined stream skipped", stream=sid)
                continue
            if not np.all(np.isfinite(np.asarray(scene.image))):
                res.ledger.add(self.ticks, "nan_drop",
                               "non-finite frame payload dropped at ingest", stream=sid)
                self._apply_fault_action(sid, res.note_fault(sid, self.ticks))
                continue
            out[sid] = scene
        return out

    def _apply_fault_action(self, sid: str, action: str) -> None:
        """Translate a health-machine verdict into scheduler state."""
        res = self.resilience
        if action == "degrade":
            st = self.streams.get(sid)
            if st is not None and st.controller.force_degrade():
                res.ledger.add(self.ticks, "degrade", "health degrade: rung forced down",
                               stream=sid)
        elif action == "quarantine":
            res.ledger.add(self.ticks, "quarantine",
                           "fault threshold reached: stream quarantined", stream=sid)

    def _retry_gate(self, rung_name: str) -> bool:
        """Burn through armed transient step faults with bounded
        exponential backoff (virtual time when a clock is wired).  True
        means the bucket may serve; False aborts it for this tick."""
        res = self.resilience
        for attempt in range(res.cfg.max_retries + 1):
            if not res.take_step_fault():
                if attempt:
                    res.ledger.add(
                        self.ticks, "retry",
                        f"{rung_name} step served after {attempt} "
                        f"retr{'y' if attempt == 1 else 'ies'}",
                        value=float(attempt))
                return True
            backoff = res.cfg.backoff_base_s * (2 ** attempt)
            if self.clock is not None:
                self.clock.advance(backoff)
            res.ledger.add(self.ticks, "retry",
                           f"transient {rung_name} step fault: backing off "
                           f"{backoff * 1e3:.1f}ms", value=backoff)
        res.ledger.add(self.ticks, "abort",
                       f"retries exhausted: {rung_name} bucket dropped this tick",
                       value=float(res.cfg.max_retries))
        return False

    def _watchdog(self, rows: list) -> None:
        res = self.resilience
        scale = res.cfg.watchdog_scale
        for r in rows:
            sid = r["stream"]
            if r["latency_s"] > scale * r["budget_s"]:
                res.ledger.add(
                    self.ticks, "watchdog",
                    f"latency {r['latency_s'] * 1e3:.2f}ms > "
                    f"{scale:g}x budget {r['budget_s'] * 1e3:.2f}ms",
                    stream=sid, value=r["latency_s"])
                self._apply_fault_action(sid, res.note_fault(sid, self.ticks))
            else:
                healthy_after = res.note_clean(sid, self.ticks)
                if healthy_after is not None:
                    res.ledger.add(
                        self.ticks, "recover",
                        f"healthy after {healthy_after} ticks degraded",
                        stream=sid, value=float(healthy_after))

    def _rebalance_shards(self, buckets: Dict[str, list]) -> None:
        """One placer-driven migration per skewed rung engine (the lowest
        stream id on the crowded shard moves; deterministic under replay).
        Slot churn only — never a new capture."""
        for rung_name in buckets:
            eng = self.engines[rung_name]
            move = self.placer.rebalance(rung_name, eng.shard_occupancy())
            if move is None:
                continue
            src, dst = move
            for sid in sorted(eng.active):
                if eng.shard_of(sid) == src:
                    eng.migrate(sid, dst)
                    if self.obs is not None:
                        self.obs.tracer.instant("shard_migrate", stream=sid, tick=self.ticks,
                                                rung=rung_name, axis="hardware", shard=dst)
                    break

    def _account_drain(self, rung_name, record, outs, echoed, latencies, outputs, rows) -> None:
        """Account one drained engine tick: a cost-model observation at its
        (rung, batch-size), then per-stream quality/miss rows paired
        against the scenes and budgets echoed from its submission."""
        lat = record.end_to_end
        # the deadline contract is judged on frame completion latency:
        # for sync ticks that IS the tick latency; for pipelined ticks it
        # spans the frame's whole residence in the pipe
        lat_frame = record.meta.get("frame_latency_s", lat)
        latencies[rung_name] = lat
        outputs.update(outs)
        b = int(record.meta["batch_size"])
        self.cost.observe(
            rung_name, record,
            SceneFeatures(batch_size=float(b), batched=True, pipeline_depth=float(self.depth)))
        for sid, (scene, budget) in echoed.items():
            st = self.streams.get(sid)
            if st is None:
                continue               # stream left while its frame flew
            out = outs[sid]
            q = frame_quality(scene, out)
            miss = lat_frame > budget
            st.frames += 1
            st.misses += int(miss)
            st.latencies.append(lat_frame)
            if q is not None:
                st.qualities.append(q)
            st.prev_proposals = out.num_proposals
            rows.append({
                "stream": sid, "rung": rung_name, "batch_size": b,
                "budget_s": budget, "latency_s": lat_frame, "miss": miss,
                "quality": q,
                "staleness": int(record.meta.get("staleness_ticks", 0.0)),
                # attribution tags: the observatory's FrameSample builder
                # groups on scenario content and per-frame work level
                "scenario": scene.scenario,
                "work": float(out.num_proposals or 0.0),
                "tick": self.ticks,
            })

    def flush(self) -> TickResult:
        """Drain every engine's in-flight pipelined work (end of run).
        Returns a ``TickResult`` (empty buckets — nothing was submitted) so
        the retired frames' detections, latencies, and accounting rows are
        all recoverable, exactly as during a regular tick."""
        latencies: Dict[str, float] = {}
        outputs: Dict[str, object] = {}
        rows: list[dict] = []
        for rung_name, eng in self.engines.items():
            for record, outs, echoed in eng.flush():
                self._account_drain(rung_name, record, outs, echoed, latencies, outputs, rows)
        return TickResult(buckets={}, latencies=latencies, outputs=outputs, rows=rows)

    # ---------------- reporting ----------------
    def report(self) -> list[dict]:
        """Per-stream outcome rows.  Floats go through ``json_num`` so an
        idle stream's undefined statistics serialize as ``null`` rather
        than the non-strict ``NaN`` literal."""
        rows = []
        for sid, st in sorted(self.streams.items()):
            lats = np.asarray(st.latencies)
            rows.append({
                "stream": sid,
                "frames": st.frames,
                "drops": st.drops,
                "miss_rate": json_num(st.miss_rate),
                "mean_quality": json_num(np.mean(st.qualities)) if st.qualities else None,
                "p99_s": json_num(np.percentile(lats, 99)) if lats.size else None,
                "switches": st.controller.switches,
            })
        return rows
