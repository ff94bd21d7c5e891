"""Approximate-time message synchronizer (paper §IV-C, Insight 6).

Mirrors ROS ``message_filters.ApproximateTimeSynchronizer``: one queue per
topic (size Q); whenever every topic holds at least one message, the
earliest candidate set whose stamp spread ≤ slop is emitted.  Queue size is
the paper's Fig. 17 knob: larger queues damp fusion-delay variance.

Loss accounting is exact: a message can die two ways — evicted from a
full queue (``dropped_overflow``) or discarded unmatched by the post-emit
sweep that clears everything at or before the matched stamps
(``dropped_sweep``).  ``dropped`` is their sum; historically only
overflow was counted, so fig16/fusion drop rates under-reported.

Queues are ``deque``s (O(1) overflow eviction instead of ``list.pop(0)``
churn) and the candidate search uses a sorted stamp index with
``searchsorted`` nearest-stamp lookups — O(Q log Q) per add instead of
the old O(Q²) head scans.  A copy of the reference's
``repro/perception/fusion.py``: the port imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

__all__ = ["ApproxTimeSynchronizer", "FusionEvent"]


@dataclasses.dataclass(frozen=True)
class FusionEvent:
    stamp: float                 # representative (earliest) source stamp
    emitted_at: float
    stamps: dict[str, float]

    @property
    def delay(self) -> float:
        return self.emitted_at - self.stamp


class ApproxTimeSynchronizer:
    def __init__(self, topics: list[str], queue_size: int = 100, slop: float = 0.1):
        self.topics = list(topics)
        self.queue_size = queue_size
        self.slop = slop
        self.queues: dict[str, deque[tuple[float, object]]] = {
            t: deque() for t in topics
        }
        self.events: list[FusionEvent] = []
        self.dropped_overflow = 0
        self.dropped_sweep = 0

    @property
    def dropped(self) -> int:
        """Total messages lost: queue-overflow evictions plus unmatched
        messages cleared by the post-emit sweep."""
        return self.dropped_overflow + self.dropped_sweep

    def add(self, topic: str, stamp: float, payload, now: float) -> Optional[FusionEvent]:
        q = self.queues.get(topic)
        if q is None:
            raise KeyError(
                f"unknown topic {topic!r}; synchronizer topics: {self.topics}"
            )
        if len(q) >= self.queue_size:
            q.popleft()                       # drop-oldest, ROS queue semantics
            self.dropped_overflow += 1
        q.append((stamp, payload))
        return self._try_emit(now)

    def _try_emit(self, now: float) -> Optional[FusionEvent]:
        if any(not q for q in self.queues.values()):
            return None
        # candidate: the set minimizing stamp spread, greedily from the
        # first topic's entries; nearest-stamp lookups go through a sorted
        # index per topic (stamps may arrive out of order)
        sorted_stamps = {
            t: np.sort(np.fromiter((s for s, _ in q), float, len(q)))
            for t, q in self.queues.items()
        }
        best = None
        others = self.topics[1:]
        for s0 in sorted_stamps[self.topics[0]]:
            stamps = {self.topics[0]: float(s0)}
            ok = True
            for t in others:
                arr = sorted_stamps[t]
                i = int(np.searchsorted(arr, s0))
                # nearest of the two sorted neighbours
                if i == 0:
                    near = arr[0]
                elif i == len(arr):
                    near = arr[-1]
                else:
                    near = arr[i] if arr[i] - s0 < s0 - arr[i - 1] else arr[i - 1]
                if abs(near - s0) > self.slop:
                    ok = False
                    break
                stamps[t] = float(near)
            if ok:
                spread = max(stamps.values()) - min(stamps.values())
                if best is None or spread < best[0]:
                    best = (spread, stamps)
        if best is None:
            return None
        _, stamps = best
        # sweep everything at or before the matched stamps; the matched
        # message itself is consumed by the emit, every other swept
        # message is an unmatched loss and must be accounted
        for t in self.topics:
            kept = deque(sp for sp in self.queues[t] if sp[0] > stamps[t])
            swept = len(self.queues[t]) - len(kept)
            self.dropped_sweep += max(swept - 1, 0)
            self.queues[t] = kept
        ev = FusionEvent(stamp=min(stamps.values()), emitted_at=now, stamps=stamps)
        self.events.append(ev)
        return ev

    def delays(self) -> list[float]:
        return [e.delay for e in self.events]
