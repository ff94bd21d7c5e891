"""Pub/sub middleware cost models (paper §III-C, Insight 2), copied from
the reference's ``repro/bus/transport.py``.

Two transports, modeled on the mechanisms the paper measured:

* ``CopyTransport`` (ROS1 IPC / TCPROS): the publisher serializes once and
  copies the message to each subscriber **in sequence order** — per-
  subscriber latency grows with its position; one copy per subscriber.

* ``DatagramTransport`` (ROS2 DDS / UDP): messages are fragmented into
  ≤64 KiB datagrams; each fragment pays a syscall + per-byte cost, and the
  receive side reassembles.  Fragment processing is served by a small
  worker pool — when subscribers exceed the pool, the overflow half
  observes much higher latency (the paper's "four fast, four slow"
  observation for 6.2 MB × 8 subscribers).

Costs are deterministic simulated seconds (seeded jitter), calibrated
against the paper's ordering: DDS wins for small messages (no copy-per-
subscriber), IPC wins for large ones (fragmentation + reassembly dominate).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["CopyTransport", "DatagramTransport", "Message", "publish_latencies"]

KB = 1024
MB = 1024 * 1024
UDP_MAX = 64 * KB


@dataclasses.dataclass(frozen=True)
class Message:
    name: str
    size_bytes: int


@dataclasses.dataclass(frozen=True)
class CopyTransport:
    """Serial copy per subscriber (ROS1 IPC)."""

    name: str = "ros1_ipc"
    setup_s: float = 120e-6           # connection/serialization overhead
    copy_bw: float = 4.0e9            # bytes/s memcpy+socket
    jitter_sigma: float = 0.08

    def latencies(self, msg: Message, n_subscribers: int, rng) -> np.ndarray:
        """Per-subscriber latency: subscriber i waits for copies 0..i."""
        per_copy = msg.size_bytes / self.copy_bw + self.setup_s
        copies = per_copy * rng.lognormal(0.0, self.jitter_sigma, n_subscribers)
        ends = np.cumsum(np.maximum(copies, 1e-7))
        return ends


@dataclasses.dataclass(frozen=True)
class DatagramTransport:
    """Fragmenting datagram transport with a receive worker pool (ROS2 DDS)."""

    name: str = "ros2_dds"
    setup_s: float = 40e-6            # discovery/QoS bookkeeping per msg
    syscall_s: float = 25e-6          # per fragment send+recv
    frag_bw: float = 1.6e9            # bytes/s through the UDP path
    reassembly_s_per_frag: float = 18e-6
    workers: int = 4                  # concurrent receive workers
    jitter_sigma: float = 0.10

    def latencies(self, msg: Message, n_subscribers: int, rng) -> np.ndarray:
        frags = max(1, math.ceil(msg.size_bytes / UDP_MAX))
        per_sub = (
            self.setup_s
            + frags * (self.syscall_s + self.reassembly_s_per_frag)
            + msg.size_bytes / self.frag_bw
        )
        base = per_sub * rng.lognormal(0.0, self.jitter_sigma, n_subscribers)
        base = np.maximum(base, 1e-7)
        # worker pool: subscribers beyond the pool wait for a free worker
        # (the paper's 4-fast / 4-slow pattern at 8 subscribers)
        ends = np.zeros(n_subscribers)
        workers_free = np.zeros(self.workers)
        order = np.arange(n_subscribers)
        for i in order:
            w = int(np.argmin(workers_free))
            start = workers_free[w]
            ends[i] = start + base[i]
            workers_free[w] = ends[i]
        return ends


def publish_latencies(
    transport, msg: Message, n_subscribers: int, n_messages: int = 200, seed: int = 0
) -> np.ndarray:
    """(n_messages, n_subscribers) latency matrix."""
    rng = np.random.default_rng(seed)
    return np.stack(
        [transport.latencies(msg, n_subscribers, rng) for _ in range(n_messages)]
    )
