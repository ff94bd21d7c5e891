"""Batched multi-camera perception engine — the perception analog of a
multi-tenant serving engine, hosted on the pipelined device-resident
executor (``repro_torch.batched.executor``).  The port of the reference's
``repro/batched/engine.py``.

The paper's runtime perspective (§IV) attributes inference-time variance
to co-resident DNN tasks contending for one accelerator; batching the
co-resident streams is the predictability mechanism.  N camera streams
that would pay N device passes, N host round-trips and N Python
post-processing passes per tick share:

* **one device step** — the rung's device pre-processing + ``infer``
  over a fixed-capacity padded batch, with the slot axis written out in
  the device functions (each slot normalised and suppressed on its own),
  captured once in a CUDA graph (one per shard).  Joining/leaving streams
  only flips an active mask and blanks a slot's buffer; shapes never
  change, so the step is captured exactly once per shard (``trace_count``:
  the executor's ``step_captures``).
* **one batched fixed-shape readback** — one copy of the whole output
  tree into pinned memory and one event wait, after which the rung's
  ``post_batch`` performs the vectorized ``_unscale``/keep-mask pass on
  host arrays.
* **a device-resident raw batch** — slot contents live on the device;
  each tick uploads only the *dirty* slots (streams that actually
  delivered a frame), not the full padded batch.

``depth=1`` (default) is the synchronous engine.  ``depth>=2`` runs ticks
as a software pipeline: ``tick`` dispatches this tick's frames and returns
the results of the tick submitted ``depth-1`` ticks ago
(``staleness_ticks`` in the record metadata), so upload, device compute,
and host post-processing overlap across consecutive ticks.

Per-tick latency is attributed to every co-resident stream (per-stream
``TimelineRecorder``): your frame took that long because of who you shared
the batch with.

**Fleet sharding** (``mesh=``): the executor splits the slot batch into
one contiguous block per shard of the mesh's data axis, each on its own
device and stream; the engine keeps one free list per shard, so a
stream's frames always land in one shard's block, and ``join``/``migrate``
take a shard.  Under virtual time each stage costs what its slowest shard
costs (``_modeled_stages_sharded``), and a traced tick carries one
``shard_serve`` span per serving shard.  With one shard all of this
reduces to the single-device engine, report for report.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..bus.clock import SimClock
from ..core.timing import STAGE_AXES, StageRecord, StageTimer, TimelineRecorder
from ..perception.data import H, W
from ..perception.pipelines import BuiltPipeline, FrameOutput, build_pipeline

from .executor import PipelinedExecutor

__all__ = ["BatchedStreamState", "BatchedPerceptionEngine"]

_NO_PAYLOAD = object()


def _slot_of(host: Any, b: int) -> Any:
    """Slot ``b`` of a host output tree (NumPy leaves)."""
    if isinstance(host, np.ndarray):
        return host[b]
    if isinstance(host, dict):
        return {k: _slot_of(v, b) for k, v in host.items()}
    return type(host)(_slot_of(v, b) for v in host)


@dataclasses.dataclass
class BatchedStreamState:
    """One seated camera stream: its slot and per-stream instrumentation."""

    stream_id: str
    slot: int
    recorder: TimelineRecorder = dataclasses.field(default_factory=TimelineRecorder)
    frames: int = 0
    last_output: Optional[FrameOutput] = None


class BatchedPerceptionEngine:
    """Serve many camera streams through one shared padded device batch.

    ``capacity`` is the static batch size; streams join into free slots
    and leave without ever changing the captured shapes.  ``tick`` runs one
    shared frame step for every active stream; with ``depth >= 2`` the
    step is pipelined and ``tick`` returns the results of an earlier
    submission (one tick stale at depth 2).

    ``pipeline`` is a registry name (built here with ``scale``,
    ``generator``, ``pad``, ``device`` and the detector kwargs) or an
    already-built pipeline.  ``params`` maps pipeline names to reference
    parameter trees of NumPy arrays (``build_pipeline``'s ``params``);
    without an entry for this pipeline the weights are drawn from
    ``generator`` (seed 7 when none is given).  ``device`` defaults to the
    card and raises without one unless ``"cpu"`` is asked for.  ``mesh``
    (``repro_torch.launch.mesh.Mesh``) shards the slot batch over its data
    axis (module docstring); the weights are copied to each shard's device.
    """

    def __init__(
        self,
        pipeline: str | BuiltPipeline,
        capacity: int = 8,
        scale: float = 1.0,
        generator: Optional[torch.Generator] = None,
        pad: bool = True,
        image_shape: tuple[int, int, int] = (H, W, 3),
        clock: Optional[SimClock] = None,
        stage_cost: Optional[Callable[[str, int, float], float]] = None,
        depth: int = 1,
        obs=None,
        obs_tag: str = "",
        device: str | torch.device = "cuda",
        params: Optional[Mapping[str, Any]] = None,
        mesh=None,
        **det_kw,
    ) -> None:
        if capacity < 1:
            raise ValueError(
                f"capacity must be >= 1 (got {capacity}): a zero-slot "
                "engine could never seat a stream"
            )
        if depth < 1:
            raise ValueError(f"depth must be >= 1 (got {depth})")
        if depth > 1 and stage_cost is not None:
            raise ValueError(
                "stage_cost (virtual-time replay) requires the synchronous "
                "depth-1 path: a modeled clock cannot observe real pipeline "
                "overlap, and replay determinism is defined on sync ticks"
            )
        if isinstance(pipeline, BuiltPipeline):
            if (scale != 1.0 or generator is not None or pad is not True or params is not None
                    or det_kw):
                raise ValueError(
                    "pipeline was passed already built; scale/generator/pad/"
                    "params/detector kwargs belong to build_pipeline and would "
                    "be silently ignored here"
                )
            self.built = pipeline
        else:
            tree = params.get(pipeline) if params is not None else None
            self.built = build_pipeline(pipeline, scale=scale, generator=generator, pad=pad,
                                        device=device, params=tree, **det_kw)
        self.capacity = capacity
        self.image_shape = image_shape
        self.depth = depth
        # virtual-time replay: ``stage_cost(stage, batch_size, work)``
        # replaces measured stage durations with a deterministic model, and
        # ``clock`` (a SimClock) is advanced by each tick's modeled latency —
        # no wall-clock in the control path, so replays are bit-reproducible.
        # Both are plain mutable attributes so a scheduler can rewire them
        # between episodes.
        self.clock = clock
        self.stage_cost = stage_cost
        # observability: a ``repro_torch.obs.Observatory`` (duck-typed; pure
        # observation — attaching one never changes control flow or, under
        # a SimClock, any emitted timestamp).  Mutable so schedulers can
        # attach/detach between episodes.
        self.obs = obs
        self.obs_tag = obs_tag

        # the λ gather indices for this frame shape, on the device, before
        # the step is ever captured
        self.built.pre_index(image_shape[:2])
        self.mesh = mesh
        self._exec = PipelinedExecutor(self.built.device_step, capacity, image_shape,
                                       depth=depth, device=self.built.device, mesh=mesh)
        self.n_shards = self._exec.n_shards
        self._slots_per_shard = capacity // self.n_shards
        self._free: list[deque[int]] = self._free_lists()
        self.active: Dict[str, BatchedStreamState] = {}
        self.ticks = 0
        self.tick_log: list[tuple[int, float]] = []   # (n_active, latency)
        self.recorder = TimelineRecorder()            # engine-level (per tick)
        self._compiled = False
        # pipelined throughput accounting: cumulative BUSY serving span
        # (burst start → drains), so neither the host-residual sum (which
        # overstates frames/s once work overlaps) nor idle gaps between
        # serving bursts (which would understate it) corrupt the figure
        self._serve_span: float = 0.0
        self._span_anchor: Optional[float] = None

    def _free_lists(self) -> list[deque[int]]:
        """One FIFO free list of slots per shard."""
        k = self._slots_per_shard
        return [deque(range(s * k, (s + 1) * k)) for s in range(self.n_shards)]

    @property
    def executor(self) -> PipelinedExecutor:
        return self._exec

    @property
    def trace_count(self) -> int:
        """Captures of the step, one per shard — must not grow after any
        churn."""
        return self._exec.step_captures

    @property
    def replay_count(self) -> int:
        """Runs of the captured step (submits and probes)."""
        return self._exec.step_replays

    # ---------------- join / leave ----------------
    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def n_free(self) -> int:
        return sum(len(d) for d in self._free)

    @property
    def in_flight(self) -> int:
        return self._exec.pending

    @property
    def slots_per_shard(self) -> int:
        return self._slots_per_shard

    def shard_of(self, stream_id: str) -> int:
        """Shard whose slot block seats this stream (0 on one shard)."""
        return self._exec.shard_of_slot(self.active[stream_id].slot)

    def shard_occupancy(self) -> list[int]:
        """Seated streams per shard — the fleet scheduler's skew signal
        for cross-shard migration."""
        return [self._slots_per_shard - len(self._free[k]) for k in range(self.n_shards)]

    def streams_on(self, shard: int) -> list[str]:
        """Stream ids seated on one shard, sorted — the evacuation order
        during shard failover (sorted so recovery is deterministic under
        replay)."""
        return sorted(sid for sid in self.active if self.shard_of(sid) == shard)

    def join(self, stream_id: str, shard: Optional[int] = None) -> BatchedStreamState:
        """Seat a stream in a free slot.  Raises when the batch is full.
        The slot's device buffer is already blank (slots are blanked on
        leave and at construction), so joining is pure bookkeeping.

        ``shard`` pins the stream to one shard's slot block; by default the
        least-occupied shard with a free slot wins (ties → lowest index),
        which on one shard is a single FIFO free list."""
        if stream_id in self.active:
            raise ValueError(f"stream {stream_id!r} is already seated")
        if shard is None:
            candidates = [k for k in range(self.n_shards) if self._free[k]]
            if not candidates:
                raise RuntimeError(
                    f"no free slot (capacity {self.capacity}, {self.n_active} active)")
            shard = min(candidates, key=lambda k: (-len(self._free[k]), k))
        else:
            if not 0 <= shard < self.n_shards:
                raise ValueError(f"shard {shard} out of range: {self.n_shards} shard(s)")
            if not self._free[shard]:
                raise RuntimeError(
                    f"no free slot in shard {shard} ({self._slots_per_shard} slots, all seated)")
        slot = self._free[shard].popleft()
        st = BatchedStreamState(stream_id=stream_id, slot=slot)
        self.active[stream_id] = st
        return st

    def leave(self, stream_id: str) -> BatchedStreamState:
        """Unseat a stream and blank its slot on the device (carve-out), so
        the next occupant never sees stale frames.  Frames of this stream
        still in flight drain normally and are returned to the caller keyed
        by this stream id (the submission snapshot), but per-stream
        accounting (frame counts, recorder, last_output) stops here."""
        st = self.active.pop(stream_id)
        self._exec.set_slot(st.slot, None)
        self._free[self._exec.shard_of_slot(st.slot)].append(st.slot)
        return st

    def migrate(self, stream_id: str, shard: int) -> BatchedStreamState:
        """Move a seated stream to another shard's slot block (carve out the
        old slot, seat into the new shard), keeping its accounting.  Shapes
        never change, so no new capture."""
        st = self.active[stream_id]
        old = self._exec.shard_of_slot(st.slot)
        if shard == old:
            return st
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range: {self.n_shards} shard(s)")
        if not self._free[shard]:
            raise RuntimeError(f"no free slot in shard {shard}")
        new_slot = self._free[shard].popleft()
        self._exec.set_slot(st.slot, None)
        self._free[old].append(st.slot)
        st.slot = new_slot
        return st

    def reset(self) -> None:
        """Unseat every stream and clear all accounting, keeping the
        captured step warm — one engine serves many episodes without a new
        capture, and a reset engine behaves as a fresh one.  In-flight
        pipelined work is *discarded*, not drained."""
        self.active.clear()
        self._free = self._free_lists()
        self._exec.reset()
        self.ticks = 0
        self.tick_log.clear()
        self.recorder = TimelineRecorder()
        self._serve_span = 0.0
        self._span_anchor = None

    # ---------------- stepping ----------------
    def compile(self) -> None:
        """Build the executor's step (on the card: capture its CUDA graph)
        so the first real tick is not a set-up outlier.  Idempotent."""
        if self._compiled:
            return
        self._exec.warmup()
        self._compiled = True

    def _post(self, host, active_mask: np.ndarray) -> list:
        """Vectorized post over an already-fetched host output tree."""
        if self.built.post_batch is not None:
            return self.built.post_batch(host, active_mask)
        # generic fallback: the tree is on host already; slice per slot
        return [
            self.built.post(_slot_of(host, b)) if active_mask[b] else None
            for b in range(self.capacity)
        ]

    def probe(self, frames=None):
        """One timed full-capacity step, *not* attributed to any stream —
        a calibration sample of the batched step cost at this capacity.
        The rung-bucket scheduler seeds its per-(rung, batch-size) cost
        model with this, so the cold-start prior is a measured batched
        step rather than the pessimistic serial bound.

        ``frames`` (a sequence of raw images, cycled across the slots)
        makes the probe representative: on blank buffers a
        post-dominated rung like two_stage would measure near-zero
        post-processing.  Resident slot contents are untouched.  Returns
        the ``StageRecord``."""
        self.compile()
        mask = np.ones(self.capacity, bool)
        timer = StageTimer()
        with timer.stage("inference"):
            host = self._exec.run_direct(frames)
        with timer.stage("post_processing"):
            self._post(host, mask)
        rec = timer.finish()
        if self.stage_cost is not None:
            # calibration sample of the *modeled* batched step at full
            # capacity (the probe is offline: it never advances the clock)
            rec.stages = {
                "inference": self.stage_cost("inference", self.capacity, 0.0),
                "post_processing": self.stage_cost("post_processing", self.capacity, 0.0),
            }
        rec.meta["batch_size"] = float(self.capacity)
        return rec

    def tick(self, frames: Mapping[str, np.ndarray], payload=_NO_PAYLOAD):
        """One shared batch step over every active stream's current frame.

        ``frames`` maps stream id → raw (H, W, 3) image; every key must be
        a seated stream.  Streams without a frame this tick keep their
        previous (or blank) slot content and receive no output — a camera
        that skipped a tick does not stall its co-residents.

        Returns ``(StageRecord, {stream_id: FrameOutput})``; the record is
        also appended to every *served* stream's recorder.

        With ``depth >= 2`` the returned results belong to the tick
        submitted ``depth-1`` ticks ago (``rec.meta["staleness_ticks"]``);
        while the pipeline is still filling, ``(None, {})`` is returned.
        Passing ``payload=`` (any object) switches the return to a
        3-tuple ``(rec, outputs, payload_of_the_drained_tick)`` so a
        scheduler can re-associate stale results with the scenes and
        budgets that produced them.
        """
        has_payload = payload is not _NO_PAYLOAD
        unknown = set(frames) - set(self.active)
        if unknown:
            raise KeyError(f"frames for unseated streams: {sorted(unknown)}")
        if not self.active or not frames:
            # nothing to serve: don't burn a capacity-wide device step or
            # log a zero-frame tick into the throughput accounting
            return (None, {}, None) if has_payload else (None, {})
        self.compile()

        snapshot = [(sid, self.active[sid].slot) for sid in frames]
        active_mask = np.zeros(self.capacity, bool)
        for _, slot in snapshot:
            active_mask[slot] = True

        if self.depth == 1:
            out = self._tick_sync(frames, snapshot, active_mask,
                                  payload if has_payload else None)
        else:
            out = self._tick_pipelined(frames, snapshot, active_mask,
                                       payload if has_payload else None)
        return out if has_payload else out[:2]

    # ---------------- sync (depth-1) path ----------------
    def _tick_sync(self, frames, snapshot, active_mask, payload):
        timer = StageTimer()
        with timer.stage("read"):
            slot_frames = {slot: frames[sid] for sid, slot in snapshot}
        with timer.stage("inference"):
            # pre-processing is fused into this device step: dirty-slot
            # upload, one graph replay, one readback
            self._exec.submit(slot_frames, payload=None)
            drained = self._exec.drain()
        with timer.stage("post_processing"):
            per_slot = self._post(drained.host, active_mask)
            outputs: Dict[str, FrameOutput] = {sid: per_slot[slot] for sid, slot in snapshot}
        rec = timer.finish()
        rec.meta["h2d_bytes"] = float(drained.h2d_bytes)
        rec.meta["staleness_ticks"] = 0.0
        self._account(rec, snapshot, outputs, len(snapshot))
        return rec, outputs, payload

    # ---------------- pipelined (depth >= 2) path ----------------
    def _tick_pipelined(self, frames, snapshot, active_mask, payload):
        t0 = time.perf_counter()
        slot_frames = {slot: frames[sid] for sid, slot in snapshot}
        read_s = time.perf_counter() - t0
        if self._exec.pending == 0:
            self._span_anchor = t0        # an idle engine starts a new burst
        # read_s rides the submission so the drained record carries ITS
        # OWN tick's read time, not the (newer) draining tick's
        self._exec.submit(slot_frames, payload=(snapshot, active_mask, payload, read_s))
        if not self._exec.ready():
            return None, {}, None          # pipeline still filling
        return self._drain_one()

    def _drain_one(self):
        """Retire the oldest in-flight submission: single readback, host
        post, honest stage attribution for the overlapped phases —
        ``read`` is the drained tick's own frame prep, ``upload`` the host
        time its submit spent dispatching (staging, copies, replay),
        ``inference`` only the *residual* device wait the overlap failed to
        hide, ``post_processing`` the host pass over the readback."""
        drained = self._exec.drain()
        snapshot, active_mask, payload, read_s = drained.payload
        t0 = time.perf_counter()
        per_slot = self._post(drained.host, active_mask)
        outputs: Dict[str, FrameOutput] = {sid: per_slot[slot] for sid, slot in snapshot}
        post_s = time.perf_counter() - t0
        rec = StageRecord(stages={
            "read": read_s,
            "upload": drained.dispatch_s,
            "inference": drained.wait_s,
            "post_processing": post_s,
        })
        rec.meta["h2d_bytes"] = float(drained.h2d_bytes)
        rec.meta["staleness_ticks"] = float(drained.staleness)
        # completion latency: a frame is usable only after its host post
        # pass, so the deadline contract (and the cost model training on
        # this field) must cover submit → readback → post
        rec.meta["frame_latency_s"] = drained.latency_s + post_s
        now = time.perf_counter()
        if self._span_anchor is not None:
            self._serve_span += now - self._span_anchor
        self._span_anchor = now
        self._account(rec, snapshot, outputs, len(snapshot))
        return rec, outputs, payload

    def flush(self) -> list:
        """Drain every in-flight pipelined submission, oldest first.
        Returns ``[(rec, outputs, payload), ...]`` (empty when nothing was
        in flight).  Used on churn (a rung bucket emptied) and at end of
        run so no frame is ever lost in the pipe."""
        out = []
        while self._exec.pending:
            out.append(self._drain_one())
        return out

    # ---------------- shared accounting ----------------
    def _account(self, rec, snapshot, outputs, n_served):
        if self.stage_cost is not None:
            if self.n_shards > 1:
                rec.stages = self._modeled_stages_sharded(snapshot, outputs)
            else:
                # replace measured wall-clock stage times with the modeled
                # per-(stage, batch-size, work) durations; post work is the
                # tick's total proposal count (what sets post time in the paper)
                work = float(sum(getattr(out, "num_proposals", 0.0) or 0.0
                                 for out in outputs.values()))
                rec.stages = {
                    "read": self.stage_cost("read", n_served, 0.0),
                    "inference": self.stage_cost("inference", n_served, 0.0),
                    "post_processing": self.stage_cost("post_processing", n_served, work),
                }
        rec.meta["n_active"] = float(self.n_active)
        rec.meta["batch_size"] = float(n_served)
        if self.clock is not None:
            rec.meta["t_virtual"] = self.clock.advance(rec.end_to_end)
        lat = rec.end_to_end

        self.ticks += 1
        self.tick_log.append((n_served, lat))
        self.recorder.add(rec)
        if self.obs is not None:
            self._emit_tick_spans(rec, n_served, snapshot)
        for sid, _slot in snapshot:
            st = self.active.get(sid)
            if st is None:
                continue               # stream left while its frame flew
            st.recorder.add(rec)
            st.frames += 1
            st.last_output = outputs[sid]

    def _modeled_stages_sharded(self, snapshot, outputs):
        """Virtual-time stage model on a multi-shard mesh: every shard
        serves its own slice of the slot batch in parallel, so each stage
        costs what its *slowest* shard costs (max over shards, evaluated at
        that shard's served count and proposal work).  Shards are visited
        in ascending index so the seeded stage-cost RNG draw order stays
        deterministic across replays."""
        per: dict[int, list[str]] = {}
        for sid, slot in snapshot:
            per.setdefault(self._exec.shard_of_slot(slot), []).append(sid)
        stages = {"read": 0.0, "inference": 0.0, "post_processing": 0.0}
        for shard in sorted(per):
            sids = per[shard]
            n = len(sids)
            work = float(sum(getattr(outputs[sid], "num_proposals", 0.0) or 0.0
                             for sid in sids))
            stages["read"] = max(stages["read"], self.stage_cost("read", n, 0.0))
            stages["inference"] = max(stages["inference"], self.stage_cost("inference", n, 0.0))
            stages["post_processing"] = max(stages["post_processing"],
                                            self.stage_cost("post_processing", n, work))
        return stages

    def _emit_tick_spans(self, rec: StageRecord, n_served: int, snapshot) -> None:
        """Lay this tick's stages on the observatory timeline.

        The tick span ends at the tick's completion time — virtual time
        when replaying under a SimClock (``t_virtual`` was just stamped by
        ``_account``), the observatory clock otherwise — and the stage
        children tile it in recorded order.  ``track`` cycles with pipeline
        depth so overlapped ticks render on parallel Perfetto rows instead
        of as malformed nesting.  On a multi-shard mesh a per-shard
        ``shard_serve`` child rides under the tick span, tagged with the
        shard id and that shard's served count."""
        obs = self.obs
        e2e = rec.end_to_end
        t_end = rec.meta.get("t_virtual")
        if t_end is None:
            t_end = obs.clock()
        t0 = t_end - e2e
        rung = self.built.name
        stream = self.obs_tag or rung
        track = self.ticks % self.depth
        parent = obs.record("tick", t0, t_end, stream=stream, tick=self.ticks, rung=rung,
                            batch_size=n_served, axis="end_to_end", track=track, parent=-1)
        t = t0
        for name, dur in rec.stages.items():
            obs.record(name, t, t + dur, stream=stream, tick=self.ticks, rung=rung,
                       batch_size=n_served, axis=STAGE_AXES.get(name, "end_to_end"),
                       track=track, parent=parent.seq)
            t += dur
        if self.n_shards > 1:
            served: dict[int, int] = {}
            for _sid, slot in snapshot:
                k = self._exec.shard_of_slot(slot)
                served[k] = served.get(k, 0) + 1
            for k in sorted(served):
                obs.record("shard_serve", t0, t_end, stream=stream, tick=self.ticks, rung=rung,
                           batch_size=served[k], axis="hardware", track=track,
                           parent=parent.seq, shard=k)

    # ---------------- reporting ----------------
    def _latency_series(self, recorder: TimelineRecorder) -> np.ndarray:
        """Per-frame latency: end-to-end host cost on the sync engine;
        submit→drain completion latency on a pipelined one (the host
        residual alone would understate what a frame actually waited)."""
        if self.depth == 1:
            return recorder.end_to_end_series()
        return recorder.meta_series("frame_latency_s")

    def per_stream_report(self) -> list[dict]:
        rows = []
        for st in self.active.values():
            series = self._latency_series(st.recorder)
            rows.append({
                "stream": st.stream_id,
                "frames": st.frames,
                "mean_s": float(series.mean()) if series.size else float("nan"),
                "p99_s": float(np.percentile(series, 99)) if series.size else float("nan"),
            })
        rows.sort(key=lambda r: r["stream"])
        return rows

    def aggregate_report(self) -> dict:
        lats = np.asarray([lat for _, lat in self.tick_log])
        frames = sum(n for n, _ in self.tick_log)
        if self.depth == 1:
            fps = frames / lats.sum() if lats.size else float("nan")
        else:
            # overlapped ticks: host-residual sums would overstate
            # throughput; divide by the cumulative busy span
            fps = frames / self._serve_span if self._serve_span > 0 else float("nan")
        frame_lats = self._latency_series(self.recorder)
        return {
            "ticks": self.ticks,
            "frames": frames,
            "frames_per_s": fps,
            "tick_mean_s": float(lats.mean()) if lats.size else float("nan"),
            "tick_p99_s": float(np.percentile(lats, 99)) if lats.size else float("nan"),
            "frame_p99_s": (float(np.percentile(frame_lats, 99))
                            if frame_lats.size else float("nan")),
            "traces": self.trace_count,
        }
