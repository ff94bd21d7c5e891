"""Training loop (``repro/train/loop.py`` in PyTorch): a train step with
gradient accumulation, and a trainer that records every step's wall time
through the paper's instrumentation stack (a ``TimelineRecorder``), so
deadline policies and c_v are first-class training metrics too.

The reference jits the step with mesh shardings; the port runs it eagerly
on one device.  The gradient comes from ``torch.autograd.grad`` of
``Model.loss``: on the card through the flash attention kernels' forward
and backward and the scans' forward kernels (their gradients the chunked
forms' under autograd), on the CPU through the plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.core.timing import StageTimer, TimelineRecorder, fence
from repro_torch.models import Model
from .data import to_device
from .optimizer import AdamWConfig, AdamWState, _walk, adamw_init, adamw_update

__all__ = ["TrainConfig", "Trainer", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    grad_accum: int = 1
    log_every: int = 10


def _rebuild(tree: Any, leaves: Iterator[torch.Tensor]) -> Any:
    """A tree shaped like ``tree`` holding ``leaves`` in sorted-key order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def make_train_step(model: Model, opt_cfg: AdamWConfig, grad_accum: int = 1) -> Callable:
    """The train step ``(params, opt_state, batch) → (params, opt_state,
    metrics)``; it updates ``params`` and the moments in place.

    With ``grad_accum > 1`` the batch is split into microbatches along the
    batch dim, run one after another; their gradients are summed in f32
    and divided by ``grad_accum``, the loss and the metrics are their
    means."""

    def grads_of(params: dict, batch: dict) -> tuple[torch.Tensor, dict, list]:
        leaves = [p for _, p in _walk(params)]
        with torch.enable_grad():
            loss, metrics = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        if grad_accum <= 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])
                     for k, v in batch.items()}
            gsum, losses, ms = None, [], []
            for i in range(grad_accum):
                l, m, g = grads_of(params, {k: v[i] for k, v in micro.items()})
                if gsum is None:
                    gsum = [x.float() for x in g]
                else:
                    for acc, x in zip(gsum, g):
                        acc.add_(x)
                losses.append(l)
                ms.append(m)
            grads = [g / grad_accum for g in gsum]
            loss = torch.stack(losses).sum() / grad_accum
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, _rebuild(params, iter(grads)), opt_state)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


class Trainer:
    """Trains on one device: initialises weights and optimizer state there,
    moves each batch there (from pinned memory for a card) and records
    per-step latency through the paper's instrumentation stack."""

    def __init__(self, model: Model, device: str | torch.device = "cuda",
                 train_cfg: Optional[TrainConfig] = None, rules: Any = None,
                 fsdp: bool = False) -> None:
        if rules is not None or fsdp:
            raise NotImplementedError(
                "sharding rules and FSDP come with sharded training (ROADMAP.md Queue 1 "
                "step 8); the port trains on one device")
        self.model = model
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda') needs a CUDA device; pass device='cpu' "
                               "to train on the CPU")
        self.cfg = train_cfg if train_cfg is not None else TrainConfig()
        self.recorder = TimelineRecorder()
        self._step_fn = make_train_step(model, self.cfg.opt, self.cfg.grad_accum)

    def init(self, seed: int = 0) -> tuple[dict, AdamWState]:
        """Seeded weights on the device, each leaf requiring grad, and a
        fresh optimizer state."""
        params = self.model.init(seed, device=self.device)
        for _, p in _walk(params):
            p.requires_grad_(True)
        return params, adamw_init(params)

    def fit(self, params: dict, opt_state: AdamWState, batches: Iterator[Any], steps: int,
            log: Callable[[int, dict], None] | None = None) -> tuple[dict, AdamWState]:
        """``steps`` train steps on ``batches`` (dicts of NumPy arrays or
        tensors).  Each step is timed as the ``train_step`` stage up to a
        fence on its loss; step 0 (kernel builds and warm-up, where the
        reference compiles) is not recorded.  ``log(i, metrics as floats)``
        every ``log_every`` steps and at the last."""
        for i in range(steps):
            batch = to_device(next(batches), self.device)
            timer = StageTimer()
            with timer.stage("train_step"):
                params, opt_state, metrics = self._step_fn(params, opt_state, batch)
                fence(metrics["loss"])
            rec = timer.finish()
            if i > 0:
                self.recorder.add(rec)
            if log and (i % self.cfg.log_every == 0 or i == steps - 1):
                log(i, {k: float(v) for k, v in metrics.items()})
        return params, opt_state

    def latency_summary(self):
        return self.recorder.summary("train_step")
