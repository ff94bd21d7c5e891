"""In-process pub/sub broker with pluggable transport cost models
(copied from the reference's ``repro/bus/pubsub.py``).

This is the I/O layer of the end-to-end perception graph (paper §IV):
nodes exchange messages through named topics; every delivery is stamped
with a simulated transport latency (from ``transport.py``) plus the real
host-side serialization work, so the end-to-end system benchmark can
attribute variance to I/O exactly like the paper does.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from typing import Any, Callable, Optional

import numpy as np

from .transport import CopyTransport, Message

__all__ = ["Envelope", "Broker", "Subscription"]


@dataclasses.dataclass(frozen=True)
class Envelope:
    topic: str
    seq: int
    stamp: float            # publish time (simulated clock)
    delivered_at: float     # arrival time at the subscriber
    payload: Any

    @property
    def transport_delay(self) -> float:
        return self.delivered_at - self.stamp


@dataclasses.dataclass
class Subscription:
    topic: str
    callback: Optional[Callable[[Envelope], None]]
    queue_size: int          # 0 = callback-only: no buffering, no drops
    queue: list = dataclasses.field(default_factory=list)
    dropped: int = 0

    def offer(self, env: Envelope) -> None:
        if self.queue_size > 0:
            if len(self.queue) >= self.queue_size:
                self.queue.pop(0)   # drop-oldest, ROS queue semantics
                self.dropped += 1
            self.queue.append(env)
        if self.callback is not None:
            self.callback(env)


class Broker:
    """Topic broker over a simulated clock.

    ``publish`` computes per-subscriber delivery times from the transport
    model and enqueues envelopes; ``deliver_until(t)`` flushes deliveries
    due by simulated time ``t`` in timestamp order.
    """

    def __init__(self, transport=None, seed: int = 0) -> None:
        self.transport = transport or CopyTransport()
        self.rng = np.random.default_rng(seed)
        self.subs: dict[str, list[Subscription]] = defaultdict(list)
        self._seq: dict[str, int] = defaultdict(int)
        self._inflight: list[tuple[float, int, Subscription, Envelope]] = []
        self._counter = 0
        self.delays: dict[str, list[float]] = defaultdict(list)

    def subscribe(
        self,
        topic: str,
        callback: Optional[Callable[[Envelope], None]] = None,
        queue_size: int = 1,
    ) -> Subscription:
        """``queue_size=0`` gives a callback-only subscription: envelopes
        are handed to the callback and never buffered, so ``dropped`` stays
        a truthful loss counter for consumers that drain synchronously."""
        if queue_size <= 0 and callback is None:
            raise ValueError(
                "queue_size=0 without a callback would silently discard "
                "every envelope; pass a callback or a positive queue_size"
            )
        sub = Subscription(topic, callback, queue_size)
        self.subs[topic].append(sub)
        return sub

    def publish(self, topic: str, payload: Any, size_bytes: int, now: float) -> int:
        seq = self._seq[topic]
        self._seq[topic] += 1
        subs = self.subs.get(topic, [])
        if not subs:
            return seq
        msg = Message(topic, size_bytes)
        lats = self.transport.latencies(msg, len(subs), self.rng)
        for sub, lat in zip(subs, lats):
            env = Envelope(topic, seq, now, now + float(lat), payload)
            self.delays[topic].append(float(lat))
            heapq.heappush(
                self._inflight, (env.delivered_at, self._counter, sub, env)
            )
            self._counter += 1
        return seq

    def deliver_until(self, t: float) -> int:
        n = 0
        while self._inflight and self._inflight[0][0] <= t:
            _, _, sub, env = heapq.heappop(self._inflight)
            sub.offer(env)
            n += 1
        return n

    def next_delivery(self) -> Optional[float]:
        return self._inflight[0][0] if self._inflight else None
