"""Pipelined device-resident executor — the batched engine's hot path as a
depth-k software pipeline, re-derived for CUDA from the reference's
``repro/batched/executor.py``.

The paper's I/O and runtime perspectives (§III, §IV) show host↔device
copies and dispatch gaps are first-order contributors to both mean latency
and variance.  A synchronous engine serializes them: upload, compute and
Python post-processing in strict sequence, the device idle through every
host phase.  Here frame *t+1*'s upload and scene acquisition overlap frame
*t*'s device step, which overlaps frame *t−1*'s host post-processing:
every device action is asynchronous on a CUDA stream, and the host waits
only in ``drain``, on the events of one output entry.

On the card:

* **The resident slot batch is one static device tensor per shard**
  (capacity/n, H, W, 3) f32, allocated once and written in place.  A
  submit copies only the dirty slots into it (runs of neighbouring dirty
  slots as one copy; all slots dirty is one whole-block copy),
  non-blocking, from a **pinned staging ring** of ``depth + 1`` buffers.
  Before the host rewrites a staging buffer it waits on the event recorded
  after that buffer's last copy, so a copy that has not run is never
  overwritten; in steady state the wait finds the event done
  (``stage_waits`` counts the times it did not).
* **The step is one CUDA graph per shard**, captured once in ``warmup``
  after a few eager warm-up runs on a side stream; every submit replays
  it.  The graph reads the static block and writes static outputs.  Right
  after each replay those outputs are copied non-blocking into the shard's
  rows of an entry of a **pinned output ring** (``depth`` entries, more
  only while a caller keeps more than ``depth`` submissions undrained) and
  an event is recorded per shard; ``drain`` waits on the entry's events and
  returns NumPy views of it: one readback a tick and no
  ``torch.cuda.synchronize()``.  The views stay valid until the next
  submit reuses the entry.
* **Capture failure raises.**  Nothing falls back to eager execution on the
  card: a step that cannot be captured (a host sync, a pageable
  host-to-device copy) is a fault of the step.
* Counters replace the reference's trace counts: ``step_captures`` (one
  per shard, whatever the churn) and ``step_replays`` (one per shard and
  submit or probe).

**Fleet sharding** (``mesh=``, a ``repro_torch.launch.mesh.Mesh`` with a
``data`` axis of n): shard *k* owns the contiguous slot block
``[k·capacity/n, (k+1)·capacity/n)``, which lives on its data row's first
device (``mesh.devices[k, 0]``; the pipeline's weights are copied there
when it is another device, ``BuiltPipeline.on``), and replays its own
captured step on its own CUDA stream, so shards on one card overlap.
Every shard replays its block every submit, as the reference's program
computes the whole padded batch; the host joins them on their events in
``drain``.  One shard (no mesh, or a data axis of 1) runs on the current
stream: the same program as the executor had before shards.

On the CPU, which a caller asks for explicitly, each shard's step runs
eagerly on its block and ``step_captures`` counts each shard's one build.

**Programs** (``PROGRAMS``): the executor has one, ``step``.  The
reference also jits ``assemble``, ``pack`` and ``slot_update`` to write the
resident batch; here slot writes are pinned host-to-device copies into the
static block (``_Shard.upload``) and a slot blank is one ``zero_``, so
those programs have no counterpart by design (the certifier counts the
copies as ``h2d_bytes``).  ``instrument(wrap)`` replaces the step before
``warmup`` builds a shard: the certifier passes recorders that count the
step on fake tensors instead of running it.  ``DECLARED_MUTATIONS`` names
the step's inputs it writes in place (none: it only reads the block),
which the certificate checks against the writes it traces.

Every submission carries a ``payload`` that ``drain`` echoes, so a caller
can re-associate a result with the (stale) tick that produced it: at depth
k, a drained result is k−1 ticks old.  Results drain oldest first.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from ..core.monitoring import BUILD_EVENT, TRACE_EVENT, record_event_duration_secs
from ..core.timing import _map_tensors, _tensors
from ..distributed.sharding import data_shards, slot_batch_spec
from ..perception.detector import canonical_device, resolve_device

__all__ = ["Drained", "PipelinedExecutor"]

# eager runs of the step on a side stream before its capture: lazy cuDNN
# and cuBLAS set-up and the allocator's first growth happen outside the graph
WARMUP_RUNS = 3


@dataclasses.dataclass
class Drained:
    """One completed pipeline entry, back on host."""

    host: Any                     # the step's output tree, NumPy leaves
    payload: Any                  # caller's submit payload, echoed
    seq: int                      # submission index (0-based)
    staleness: int                # ticks spent in flight (depth-1 in steady state)
    h2d_bytes: int                # dirty-slot bytes uploaded by its submit
    dispatch_s: float             # host time its submit spent dispatching
    wait_s: float                 # host time drain blocked on the readback
    latency_s: float              # wall clock from submit to drained


@dataclasses.dataclass
class _InFlight:
    host: Any                     # CPU: the output tree; CUDA: None (in the ring)
    entry: int                    # CUDA: output ring entry
    payload: Any
    seq: int
    submitted_at: int             # submit counter value when enqueued
    h2d_bytes: int
    dispatch_s: float
    t_submit: float


def _runs(slots: list[int]) -> list[tuple[int, int]]:
    """Sorted slots as [start, stop) runs of neighbours."""
    runs: list[tuple[int, int]] = []
    for s in slots:
        if runs and runs[-1][1] == s:
            runs[-1] = (runs[-1][0], s + 1)
        else:
            runs.append((s, s + 1))
    return runs


def _traced(step_fn: Callable[[torch.Tensor], Any], raw: torch.Tensor) -> Any:
    """One run of the step's Python body during a build, reported as a
    ``TRACE_EVENT`` of its host seconds (launches only, on the card)."""
    t0 = time.perf_counter()
    out = step_fn(raw)
    record_event_duration_secs(TRACE_EVENT, time.perf_counter() - t0)
    return out


def _cat(trees: list) -> Any:
    """Output trees of consecutive slot blocks joined along the slot dim."""
    if len(trees) == 1:
        return trees[0]
    leaves = iter([torch.cat(ls) for ls in zip(*(list(_tensors(t)) for t in trees))])
    return _map_tensors(lambda _: next(leaves), trees[0])


class _Shard:
    """One contiguous slot block ``[lo, hi)`` on ``device``: its static
    batch, its pinned staging ring and (on the card) its captured step, run
    on ``stream`` (None: the device's current stream)."""

    def __init__(self, lo: int, hi: int, image_shape: tuple, depth: int, device: torch.device,
                 own_stream: bool) -> None:
        self.lo, self.hi, self.device = lo, hi, device
        self.cuda = device.type == "cuda"
        shape = (hi - lo, *image_shape)
        self.raw = torch.zeros(shape, dtype=torch.float32, device=device)
        self.stream: Optional[torch.cuda.Stream] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None                   # the captured step's output tree
        self.out_leaves: list[torch.Tensor] = []
        if self.cuda:
            if own_stream:
                self.stream = torch.cuda.Stream(device)
                self.stream.wait_stream(torch.cuda.current_stream(device))   # raw's zero fill
            self.stage = [torch.empty(shape, dtype=torch.float32, pin_memory=True)
                          for _ in range(depth + 1)]
            self.stage_np = [t.numpy() for t in self.stage]
            self.stage_events = [torch.cuda.Event() for _ in self.stage]
            self.stage_next = 0

    def on_stream(self):
        """The shard's stream (and device) as the current one; a no-op on
        the CPU."""
        if not self.cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream if self.stream is not None
                                 else torch.cuda.current_stream(self.device))

    def upload(self, frames: Mapping[int, np.ndarray]) -> bool:
        """Write checked frames into their block-local slots; True when a
        staging buffer's earlier copy had to be waited for."""
        if not self.cuda:
            for slot, f in frames.items():
                self.raw[slot].copy_(torch.from_numpy(f))
            return False
        r = self.stage_next
        self.stage_next = (r + 1) % len(self.stage)
        event = self.stage_events[r]
        waited = not event.query()
        if waited:
            event.synchronize()      # the copy that last read this buffer
        host = self.stage_np[r]
        for slot, f in frames.items():
            np.copyto(host[slot], f)
        with self.on_stream():
            for a, b in _runs(sorted(frames)):
                self.raw[a:b].copy_(self.stage[r][a:b], non_blocking=True)
            event.record()
        return waited

    def blank(self, slot: Optional[int] = None) -> None:
        """Zero one block-local slot (None: the whole block), in order on
        the shard's stream."""
        with self.on_stream():
            (self.raw if slot is None else self.raw[slot]).zero_()

    def build(self, step_fn: Callable[[torch.Tensor], Any]) -> None:
        """CPU: one eager run.  Card: eager warm-up runs on a side stream,
        then the capture of one CUDA graph over the static block; raises if
        the step cannot be captured.  Every run of ``step_fn`` here is
        reported as a ``TRACE_EVENT`` and the finished build as one
        ``BUILD_EVENT`` (``core.monitoring``), with their host seconds."""
        t_build = time.perf_counter()
        if not self.cuda:
            _traced(step_fn, self.raw.clone())
            record_event_duration_secs(BUILD_EVENT, time.perf_counter() - t_build)
            return
        with torch.cuda.device(self.device):
            home = self.stream if self.stream is not None else torch.cuda.current_stream()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(home)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    _traced(step_fn, self.raw)
            home.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                # captured on the side stream: torch's default capture stream
                # lives on whichever device first asked for one
                with torch.cuda.graph(graph, stream=side):
                    # contiguous outputs: each readback is then one plain copy
                    # (a strided source would cost a kernel outside the graph)
                    out = _map_tensors(torch.Tensor.contiguous, _traced(step_fn, self.raw))
            except RuntimeError as exc:
                raise RuntimeError(
                    "the batched step could not be captured in a CUDA graph; on the card the "
                    f"executor runs no step eagerly: {exc}") from exc
        self.graph, self.out = graph, out
        self.out_leaves = list(_tensors(out))
        record_event_duration_secs(BUILD_EVENT, time.perf_counter() - t_build)


class PipelinedExecutor:
    """Depth-k pipeline over a device-resident padded batch.

    ``depth=1`` is fully synchronous in effect (the caller drains each
    submit in the same tick); ``depth>=2`` keeps up to ``depth`` steps in
    flight and ``drain`` returns the oldest.  ``step_fn`` maps a
    (slots, H, W, 3) batch to a tree (tensor, tuple, list or dict) of
    tensors that lead with the slot dim, on the batch's device.  ``mesh``
    splits the slots into per-shard blocks (module docstring); without one
    the batch lives on ``device``.
    """

    PROGRAMS = ("step",)
    # input positions each program writes in place (``instrument``)
    DECLARED_MUTATIONS = {"step": ()}

    def __init__(
        self,
        step_fn: Callable[[torch.Tensor], Any],
        capacity: int,
        image_shape: tuple[int, int, int],
        depth: int = 1,
        device: str | torch.device = "cuda",
        mesh=None,
    ) -> None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1 (got {depth})")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 (got {capacity})")
        slot_batch_spec(mesh, capacity)          # raises on a ragged split
        self.mesh = mesh
        self.n_shards = data_shards(mesh)
        if mesh is None:
            devices = [resolve_device(device)]
        else:
            devices = [canonical_device(mesh.devices[k, 0]) for k in range(self.n_shards)]
            if len({d.type for d in devices}) > 1:
                raise ValueError(f"a mesh's shards must share one device type: {devices}")
        self.device = devices[0]
        self._cuda = self.device.type == "cuda"
        self.capacity = capacity
        self.image_shape = tuple(image_shape)
        self.depth = depth
        self.frame_bytes = int(np.prod(self.image_shape)) * 4   # f32
        self._step_fn = step_fn
        self.step_captures = 0
        self.step_replays = 0
        self.stage_waits = 0       # staging-buffer event waits that found work pending
        per = capacity // self.n_shards
        self._shards = [_Shard(k * per, (k + 1) * per, self.image_shape, depth, d,
                               own_stream=self.n_shards > 1) for k, d in enumerate(devices)]
        self._queue: deque[_InFlight] = deque()
        self._seq = 0
        self._built = False

    def programs(self) -> dict:
        """The live program per short name in ``PROGRAMS``."""
        return {name: getattr(self, f"_{name}_fn") for name in self.PROGRAMS}

    def instrument(self, wrap) -> dict:
        """Replace every program with ``wrap(name, fn)`` and return the
        wrappers keyed by short name.  Call it before ``warmup``: a built
        shard has already captured (on the card) the step it was given."""
        if self._built:
            raise RuntimeError("instrument() after warmup: the shards already hold their step")
        out = {}
        for name, fn in self.programs().items():
            wrapped = wrap(name, fn)
            setattr(self, f"_{name}_fn", wrapped)
            out[name] = wrapped
        return out

    def shard_of_slot(self, slot: int) -> int:
        """Which shard owns a slot (contiguous block partition)."""
        return slot // (self.capacity // self.n_shards)

    @property
    def _raw(self) -> torch.Tensor:
        """The resident batch: every shard's block in slot order."""
        return _cat([sh.raw.to(self.device) for sh in self._shards])

    # ---------------- resident-batch maintenance ----------------
    def _checked(self, frame) -> np.ndarray:
        """Coerce one host frame, rejecting shape mismatches loudly (the
        static batch has one frame shape; a wrong one must not be cut or
        broadcast into it)."""
        f = np.ascontiguousarray(np.asarray(frame, np.float32))
        if f.shape != self.image_shape:
            raise ValueError(f"frame shape {f.shape} != executor image shape {self.image_shape}")
        return f

    def _check_slot(self, slot: int) -> None:
        if not 0 <= slot < self.capacity:
            raise IndexError(f"slot {slot} out of range [0, {self.capacity})")

    def _upload(self, frames: Mapping[int, np.ndarray]) -> None:
        """Write checked frames into their slots of the resident batch,
        each shard's through its own staging ring."""
        per_shard: dict[int, dict[int, np.ndarray]] = {}
        for slot, f in frames.items():
            k = self.shard_of_slot(slot)
            per_shard.setdefault(k, {})[slot - self._shards[k].lo] = f
        for k in sorted(per_shard):
            self.stage_waits += self._shards[k].upload(per_shard[k])

    def set_slot(self, slot: int, frame: Optional[np.ndarray]) -> None:
        """Out-of-band per-slot write (``None`` blanks the slot), in place on
        its shard's stream, ordered after every step already submitted."""
        self._check_slot(slot)
        if frame is None:
            sh = self._shards[self.shard_of_slot(slot)]
            sh.blank(slot - sh.lo)
        else:
            self._upload({slot: self._checked(frame)})

    def reset(self) -> None:
        """Drop all in-flight work and blank the resident batch (in place:
        the captured graphs keep reading the same memory)."""
        self._queue.clear()
        for sh in self._shards:
            sh.blank()
        if self._built and self._cuda:
            self._free = deque(range(len(self._ring)))

    def warmup(self) -> None:
        """Build the step once per shard: on the card, eager warm-up runs
        on a side stream, then the capture of one CUDA graph over the
        shard's static block, and the pinned output ring sized from the
        graphs' outputs.  Raises if a step cannot be captured.  Resident
        slot contents are untouched (the step only reads them).
        Idempotent."""
        if self._built:
            return
        for sh in self._shards:
            sh.build(self._step_fn)
            self.step_captures += 1
        if self._cuda:
            first = self._shards[0].out_leaves
            for sh in self._shards:
                shapes = [tuple(t.shape) for t in sh.out_leaves]
                if shapes != [tuple(t.shape) for t in first] or any(
                        s[:1] != (sh.hi - sh.lo,) for s in shapes):
                    raise ValueError(f"the step's outputs must lead with the slot dim: {shapes}")
            self._ring: list[list[torch.Tensor]] = []
            self._ring_np: list[list[np.ndarray]] = []
            self._ring_rows: list[list[list[torch.Tensor]]] = []   # [entry][shard][leaf]
            self._ring_events: list[list[torch.cuda.Event]] = []   # [entry][shard]
            for _ in range(self.depth):
                self._grow()
            self._free = deque(range(self.depth))
        self._built = True

    def _grow(self) -> int:
        """One more pinned output entry (past ``depth`` only while a caller
        holds more submissions undrained)."""
        bufs = [torch.empty((self.capacity, *t.shape[1:]), dtype=t.dtype, pin_memory=True)
                for t in self._shards[0].out_leaves]
        self._ring.append(bufs)
        self._ring_np.append([b.numpy() for b in bufs])
        self._ring_rows.append([[b[sh.lo:sh.hi] for b in bufs] for sh in self._shards])
        self._ring_events.append([torch.cuda.Event() for _ in self._shards])
        return len(self._ring) - 1

    def _tree(self, leaves: list) -> Any:
        """The step's output nesting around ``leaves`` (in ``_tensors`` order)."""
        it = iter(leaves)
        return _map_tensors(lambda _: next(it), self._shards[0].out)

    def _replay(self) -> int:
        """Replay every shard's step and start the copy of its outputs into
        its rows of a free output entry, each marked by the shard's event
        of that entry; returns the entry."""
        entry = self._free.popleft() if self._free else self._grow()
        for k, sh in enumerate(self._shards):
            with sh.on_stream():
                sh.graph.replay()
                for dst, src in zip(self._ring_rows[entry][k], sh.out_leaves):
                    dst.copy_(src, non_blocking=True)
                self._ring_events[entry][k].record()
        self.step_replays += self.n_shards
        return entry

    def _wait(self, entry: int) -> None:
        for event in self._ring_events[entry]:
            event.synchronize()

    def _run_cpu(self, blocks: list) -> Any:
        """The CPU's eager step over each shard's block, joined."""
        self.step_replays += self.n_shards
        return _map_tensors(lambda t: t.numpy(), _cat([self._step_fn(b) for b in blocks]))

    def run_direct(self, frames=None):
        """One blocking step *outside* the pipeline (calibration probes):
        over the resident batch (``frames is None``) or over ``frames``
        cycled across the slots, after which the resident contents are put
        back as they were.  Returns the output tree as NumPy arrays the
        caller owns."""
        self.warmup()
        checked = None
        if frames is not None:
            checked = {b: self._checked(frames[b % len(frames)]) for b in range(self.capacity)}
        if not self._cuda:
            blocks = [sh.raw.clone() for sh in self._shards]
            if checked is not None:
                for b, f in checked.items():
                    sh = self._shards[self.shard_of_slot(b)]
                    blocks[self.shard_of_slot(b)][b - sh.lo].copy_(torch.from_numpy(f))
            return self._run_cpu(blocks)
        saved = None
        if checked is not None:
            saved = []
            for sh in self._shards:
                with sh.on_stream():
                    saved.append(sh.raw.clone())
            self._upload(checked)
        entry = self._replay()
        if saved is not None:
            for sh, kept in zip(self._shards, saved):
                with sh.on_stream():
                    sh.raw.copy_(kept)
        self._wait(entry)
        host = self._tree([a.copy() for a in self._ring_np[entry]])
        self._free.append(entry)
        return host

    # ---------------- the pipeline ----------------
    @property
    def pending(self) -> int:
        return len(self._queue)

    def ready(self) -> bool:
        """True when the pipeline is full: the caller should drain one
        result before (or after) the next submit to hold steady depth."""
        return len(self._queue) >= self.depth

    def submit(self, slot_frames: Mapping[int, np.ndarray], payload: Any = None) -> int:
        """Dispatch one tick: upload the dirty slots, launch every shard's
        step.  Never waits for device work (save, rarely, a staging
        buffer's own earlier copy).  Returns the submission's sequence
        number."""
        t0 = time.perf_counter()
        for slot in slot_frames:
            self._check_slot(slot)
        frames = {slot: self._checked(f) for slot, f in slot_frames.items()}
        self.warmup()
        self._upload(frames)
        if self._cuda:
            entry, host = self._replay(), None
        else:
            entry, host = -1, self._run_cpu([sh.raw for sh in self._shards])
        seq = self._seq
        self._seq += 1
        self._queue.append(_InFlight(
            host=host, entry=entry, payload=payload, seq=seq, submitted_at=self._seq,
            h2d_bytes=len(frames) * self.frame_bytes,
            # tvlint: disable=TV006 (dispatch_s deliberately measures async
            # enqueue cost, not execution; drain() waits on the events before latency_s)
            dispatch_s=time.perf_counter() - t0, t_submit=t0))
        return seq

    def drain(self) -> Drained:
        """Wait for the OLDEST in-flight step and return its outputs after
        one readback (on the card: one event wait per shard; NumPy views of
        its pinned output entry, valid until the next submit)."""
        if not self._queue:
            raise RuntimeError("drain() on an empty pipeline")
        entry = self._queue.popleft()
        t0 = time.perf_counter()
        host = entry.host
        if self._cuda:
            self._wait(entry.entry)
            host = self._tree(self._ring_np[entry.entry])
            self._free.append(entry.entry)
        t1 = time.perf_counter()
        return Drained(
            host=host, payload=entry.payload, seq=entry.seq,
            staleness=self._seq - entry.submitted_at,
            h2d_bytes=entry.h2d_bytes, dispatch_s=entry.dispatch_s,
            wait_s=t1 - t0, latency_s=t1 - entry.t_submit)

    def flush(self) -> list[Drained]:
        """Drain everything in flight, oldest first."""
        out = []
        while self._queue:
            out.append(self.drain())
        return out
