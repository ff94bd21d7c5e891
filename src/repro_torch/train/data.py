"""Synthetic token data pipeline (``repro/train/data.py``, kept as a copy).

Deterministic, seeded, host-side generation of training batches for every
family (tokens / frames+labels / tokens+patch_embeds) with NumPy: the same
draws as the reference, so a batch is equal bit for bit in the two
packages.  Structured like a real pipeline: an index-based sampler, a
prefetch buffer, and per-batch read-stage timing so the paper's
I/O-variance analysis applies to training input pipelines too.
``to_device`` moves a batch onto the card from pinned memory;
``batch_rows`` takes a rank's rows of a global batch on a training mesh.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import _data_or_replicated

__all__ = ["DataConfig", "synthetic_batches", "PrefetchIterator", "make_batch_np", "to_device",
           "batch_rows"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0
    # Markov-chain order-0 token distribution with Zipf skew: more realistic
    # gather patterns on the embedding than uniform tokens.
    zipf_alpha: float = 1.1


def _zipf_probs(vocab: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return (p / p.sum()).astype(np.float64)


def make_batch_np(cfg: ModelConfig, data: DataConfig, step: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(data.seed * 1_000_003 + step)
    b, s = data.batch, data.seq_len
    if cfg.family == "audio":
        frames = rng.standard_normal((b, s, cfg.frontend_dim), dtype=np.float32)
        mask = rng.random((b, s)) < 0.08   # HuBERT-style 8% mask rate
        labels = np.where(mask, rng.integers(0, cfg.vocab_size, (b, s)), -1).astype(np.int32)
        return {"frames": frames, "labels": labels}
    probs = _zipf_probs(cfg.vocab_size, data.zipf_alpha)
    if cfg.family == "vlm":
        p = cfg.frontend_tokens
        toks = rng.choice(cfg.vocab_size, size=(b, s - p), p=probs).astype(np.int32)
        patches = rng.standard_normal((b, p, cfg.frontend_dim), dtype=np.float32)
        return {"tokens": toks, "patch_embeds": patches}
    toks = rng.choice(cfg.vocab_size, size=(b, s), p=probs).astype(np.int32)
    return {"tokens": toks}


def synthetic_batches(
    cfg: ModelConfig, data: DataConfig, start_step: int = 0
) -> Iterator[dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch_np(cfg, data, step)
        step += 1


def to_device(batch: dict[str, Any], device: str | torch.device) -> dict[str, torch.Tensor]:
    """A batch of NumPy arrays (or tensors) on ``device``: to a card from
    pinned host memory without blocking the host, to the CPU as is."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def batch_rows(batch: dict[str, Any], mesh, rules, grad_accum: int = 1) -> dict[str, Any]:
    """This rank's rows of a global batch (NumPy arrays or tensors) on a
    training mesh.  The batch is first cut into ``grad_accum`` microbatches
    along its leading dim, as the train step cuts it, and each microbatch's
    rows split over the data axes by ``batch_specs``' rule
    (``_data_or_replicated``): rank ``r`` of ``n`` takes rows ``[:, r]`` of
    the batch seen as ``(grad_accum, n, rows / (grad_accum * n), ...)``, so
    its own microbatches are its share of the global ones.  Rows that do
    not divide over the data axes (a global batch of 1) are whole on every
    rank; a prefix of the data axes (``pod``) is tried first."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {k!r} of {b} rows does not split into {grad_accum} "
                             f"microbatches")
        micro = b // grad_accum
        axes = _data_or_replicated(mesh, rules, micro)
        n = mesh.axis_size(axes)
        if n == 1:
            out[k] = v
            continue
        rows = v.reshape(grad_accum, n, micro // n, *v.shape[1:])[:, mesh.index(axes)]
        out[k] = rows.reshape(grad_accum * (micro // n), *v.shape[1:])
    return out


class PrefetchIterator:
    """Background-thread prefetch (depth-N), mirroring a production input
    pipeline; exposes per-batch producer latency for I/O-variance analysis.

    ``clock`` is injectable (``bus.clock.SimClock`` compatible, like every
    other timing site in the stack) so training-loop traces can run on
    virtual time; it defaults to wall clock."""

    def __init__(self, it: Iterator[Any], depth: int = 2,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._clock = clock if clock is not None else time.perf_counter
        self.produce_times: list[float] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            for item in self._it:
                t0 = self._clock()
                self._q.put(item)
                self.produce_times.append(self._clock() - t0)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
