"""Pipelined device-resident executor — the batched engine's hot path as a
depth-k software pipeline, re-derived for CUDA from the reference's
``repro/batched/executor.py``.

The paper's I/O and runtime perspectives (§III, §IV) show host↔device
copies and dispatch gaps are first-order contributors to both mean latency
and variance.  A synchronous engine serializes them: upload, compute and
Python post-processing in strict sequence, the device idle through every
host phase.  Here frame *t+1*'s upload and scene acquisition overlap frame
*t*'s device step, which overlaps frame *t−1*'s host post-processing:
every device action is asynchronous on the current CUDA stream, and the
host waits only in ``drain``, on one event.

On the card:

* **The resident slot batch is one static device tensor**
  (capacity, H, W, 3) f32, allocated once and written in place.  A submit
  copies only the dirty slots into it (runs of neighbouring dirty slots as
  one copy; all slots dirty is one whole-batch copy), non-blocking, from a
  **pinned staging ring** of ``depth + 1`` buffers.  Before the host
  rewrites a staging buffer it waits on the event recorded after that
  buffer's last copy, so a copy that has not run is never overwritten; in
  steady state the wait finds the event done (``stage_waits`` counts the
  times it did not).
* **The step is one CUDA graph**, captured once in ``warmup`` after a few
  eager warm-up runs on a side stream; every submit replays it.  The graph
  reads the static batch and writes static outputs.  Right after each
  replay those outputs are copied non-blocking into an entry of a **pinned
  output ring** (``depth`` entries, more only while a caller keeps more
  than ``depth`` submissions undrained) and an event is recorded; ``drain``
  waits on that event and returns NumPy views of the entry: one readback a
  tick and no ``torch.cuda.synchronize()``.  The views stay valid until the
  next submit reuses the entry.
* **Capture failure raises.**  Nothing falls back to eager execution on the
  card: a step that cannot be captured (a host sync, a pageable
  host-to-device copy) is a fault of the step.
* Counters replace the reference's trace counts: ``step_captures`` (one
  per executor, whatever the churn) and ``step_replays``.

On the CPU, which a caller asks for explicitly, the step runs eagerly on
the resident batch and ``step_captures`` counts its one build.

Every submission carries a ``payload`` that ``drain`` echoes, so a caller
can re-associate a result with the (stale) tick that produced it: at depth
k, a drained result is k−1 ticks old.  Results drain oldest first.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from ..core.timing import _map_tensors, _tensors
from ..perception.detector import resolve_device

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


class PipelinedExecutor:
    """Depth-k pipeline over a device-resident padded batch.

    ``depth=1`` is fully synchronous in effect (the caller drains each
    submit in the same tick); ``depth>=2`` keeps up to ``depth`` steps in
    flight and ``drain`` returns the oldest.  ``step_fn`` maps the
    (capacity, H, W, 3) batch to a tree (tensor, tuple, list or dict) of
    tensors.
    """

    def __init__(
        self,
        step_fn: Callable[[torch.Tensor], Any],
        capacity: int,
        image_shape: tuple[int, int, int],
        depth: int = 1,
        device: str | torch.device = "cuda",
    ) -> None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1 (got {depth})")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 (got {capacity})")
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self.capacity = capacity
        self.image_shape = tuple(image_shape)
        self.depth = depth
        self.frame_bytes = int(np.prod(self.image_shape)) * 4   # f32
        self.n_shards = 1          # one device; the mesh form is a later step
        self._step_fn = step_fn
        self.step_captures = 0
        self.step_replays = 0
        self.stage_waits = 0       # staging-buffer event waits that found work pending
        self._raw = torch.zeros((capacity, *self.image_shape), dtype=torch.float32,
                                device=self.device)
        self._queue: deque[_InFlight] = deque()
        self._seq = 0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._built = False
        if self._cuda:
            shape = (capacity, *self.image_shape)
            self._stage = [torch.empty(shape, dtype=torch.float32, pin_memory=True)
                           for _ in range(depth + 1)]
            self._stage_np = [t.numpy() for t in self._stage]
            self._stage_events = [torch.cuda.Event() for _ in self._stage]
            self._stage_next = 0

    def shard_of_slot(self, slot: int) -> int:
        """Which shard owns a slot (contiguous block partition; one shard)."""
        return slot // (self.capacity // self.n_shards)

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
        """Write checked frames into their slots of the resident batch."""
        if not frames:
            return
        if not self._cuda:
            for slot, f in frames.items():
                self._raw[slot].copy_(torch.from_numpy(f))
            return
        r = self._stage_next
        self._stage_next = (r + 1) % len(self._stage)
        event = self._stage_events[r]
        if not event.query():
            self.stage_waits += 1
            event.synchronize()      # the copy that last read this buffer
        host = self._stage_np[r]
        for slot, f in frames.items():
            np.copyto(host[slot], f)
        for a, b in _runs(sorted(frames)):
            self._raw[a:b].copy_(self._stage[r][a:b], non_blocking=True)
        event.record()

    def set_slot(self, slot: int, frame: Optional[np.ndarray]) -> None:
        """Out-of-band per-slot write (``None`` blanks the slot), in place on
        the stream, ordered after every step already submitted."""
        self._check_slot(slot)
        if frame is None:
            self._raw[slot].zero_()
        else:
            self._upload({slot: self._checked(frame)})

    def reset(self) -> None:
        """Drop all in-flight work and blank the resident batch (in place:
        the captured graph keeps reading the same memory)."""
        self._queue.clear()
        self._raw.zero_()
        if self._graph is not None:
            self._free = deque(range(len(self._ring)))

    def warmup(self) -> None:
        """Build the step once: on the card, eager warm-up runs on a side
        stream, then the capture of one CUDA graph over the static batch,
        and the pinned output ring sized from the graph's outputs.  Raises
        if the step cannot be captured.  Resident slot contents are
        untouched (the step only reads them).  Idempotent."""
        if self._built:
            return
        if not self._cuda:
            self._step_fn(self._raw.clone())
            self._built = True
            self.step_captures += 1
            return
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._step_fn(self._raw)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                # contiguous outputs: each readback is then one plain copy
                # (a strided source would cost a kernel outside the graph)
                out = _map_tensors(torch.Tensor.contiguous, self._step_fn(self._raw))
        except RuntimeError as exc:
            raise RuntimeError(
                "the batched step could not be captured in a CUDA graph; on the card the "
                f"executor runs no step eagerly: {exc}") from exc
        self._graph, self._out = graph, out
        self._out_leaves = list(_tensors(out))
        self._ring: list[list[torch.Tensor]] = []
        self._ring_np: list[list[np.ndarray]] = []
        self._ring_events: list[torch.cuda.Event] = []
        for _ in range(self.depth):
            self._grow()
        self._free = deque(range(self.depth))
        self._built = True
        self.step_captures += 1

    def _grow(self) -> int:
        """One more pinned output entry (past ``depth`` only while a caller
        holds more submissions undrained)."""
        bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in self._out_leaves]
        self._ring.append(bufs)
        self._ring_np.append([b.numpy() for b in bufs])
        self._ring_events.append(torch.cuda.Event())
        return len(self._ring) - 1

    def _tree(self, leaves: list) -> Any:
        """The step's output nesting around ``leaves`` (in ``_tensors`` order)."""
        it = iter(leaves)
        return _map_tensors(lambda _: next(it), self._out)

    def _replay(self) -> int:
        """Replay the step and start the copy of its outputs into a free
        output entry, marked by that entry's event; returns the entry."""
        self._graph.replay()
        self.step_replays += 1
        entry = self._free.popleft() if self._free else self._grow()
        for dst, src in zip(self._ring[entry], self._out_leaves):
            dst.copy_(src, non_blocking=True)
        self._ring_events[entry].record()
        return entry

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
            batch = self._raw.clone()
            if checked is not None:
                for b, f in checked.items():
                    batch[b].copy_(torch.from_numpy(f))
            self.step_replays += 1
            return _map_tensors(lambda t: t.numpy(), self._step_fn(batch))
        saved = self._raw.clone() if checked is not None else None
        if checked is not None:
            self._upload(checked)
        entry = self._replay()
        if saved is not None:
            self._raw.copy_(saved)
        self._ring_events[entry].synchronize()
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
        """Dispatch one tick: upload the dirty slots, launch the step.
        Never waits for device work (save, rarely, a staging buffer's own
        earlier copy).  Returns the submission's sequence number."""
        t0 = time.perf_counter()
        for slot in slot_frames:
            self._check_slot(slot)
        frames = {slot: self._checked(f) for slot, f in slot_frames.items()}
        self.warmup()
        self._upload(frames)
        if self._cuda:
            entry, host = self._replay(), None
        else:
            self.step_replays += 1
            entry, host = -1, _map_tensors(lambda t: t.numpy(), self._step_fn(self._raw))
        seq = self._seq
        self._seq += 1
        self._queue.append(_InFlight(
            host=host, entry=entry, payload=payload, seq=seq, submitted_at=self._seq,
            h2d_bytes=len(frames) * self.frame_bytes,
            dispatch_s=time.perf_counter() - t0, t_submit=t0))
        return seq

    def drain(self) -> Drained:
        """Wait for the OLDEST in-flight step and return its outputs after
        one readback (on the card: one event wait; NumPy views of its
        pinned output entry, valid until the next submit)."""
        if not self._queue:
            raise RuntimeError("drain() on an empty pipeline")
        entry = self._queue.popleft()
        t0 = time.perf_counter()
        host = entry.host
        if self._cuda:
            self._ring_events[entry.entry].synchronize()
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
