"""Batched multi-camera perception serving (the port of ``repro.batched``).

``executor``  — ``PipelinedExecutor``: depth-k software pipeline over a
                device-resident padded batch (dirty-slot-only H2D from a
                pinned staging ring, the step captured once in a CUDA
                graph and replayed each tick, one pinned readback a tick
                waited for on an event) so upload, compute, and host
                post-processing overlap across consecutive ticks.
``engine``    — ``BatchedPerceptionEngine``: N camera streams share one
                fixed-capacity padded device batch (device pre-processing +
                inference with the slot axis written out, one batched
                readback, vectorized post) with slot carve-out so join/leave
                never captures anew.  ``depth=1`` is synchronous;
                ``depth>=2`` pipelines ticks (results one tick stale at
                depth 2).
``scheduler`` — ``RungBucketScheduler``: per-stream anytime controllers
                bucket streams by chosen rung each tick; the shared cost
                model learns per-(rung, batch-size) latency so deadline
                decisions account for batching delay (and, pipelined, for
                pipeline depth).
``fleet``     — ``FleetPlacer``: predicted-cost seat choice over shards
                (inert on one device).
"""
from .engine import BatchedPerceptionEngine, BatchedStreamState
from .executor import Drained, PipelinedExecutor
from .scheduler import RungBucketScheduler, ScheduledStream, TickResult

__all__ = [
    "BatchedPerceptionEngine",
    "BatchedStreamState",
    "Drained",
    "PipelinedExecutor",
    "RungBucketScheduler",
    "ScheduledStream",
    "TickResult",
]
