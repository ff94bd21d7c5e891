"""Serving engine: batched decode with per-stage latency instrumentation
and deadline monitoring (``repro/runtime/engine.py`` in PyTorch).

``Engine.generate`` keeps the reference's semantics: the prompt is fed
token by token to fill the cache, then ``max_new_tokens`` are decoded
greedily, each one a job with read, inference and post_processing stages.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.deadline import DeadlinePolicy, MeanDeadline
from repro_torch.core.timing import StageTimer, TimelineRecorder, fence
from repro_torch.models import DecodeState, Model

__all__ = ["ServeConfig", "Engine", "make_serve_step", "make_prefill_step"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int
    context: int
    temperature: float = 0.0     # 0 = greedy; unused, as in the reference
    warmup_steps: int = 1


def make_serve_step(model: Model) -> Callable:
    """serve_step(params, state, tokens(B,)) → (next_tokens, logits, state).

    Greedy argmax keeps the step deterministic, so sampling noise does not
    contaminate the latency-variance measurements."""

    def serve_step(params, state: DecodeState, tokens: torch.Tensor):
        logits, state = model.decode_step(params, state, tokens)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, logits, state

    return serve_step


def make_prefill_step(model: Model) -> Callable:
    """prefill_step(params, batch) → logits for the full prompt."""

    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        return logits

    return prefill_step


class Engine:
    """Instrumented decode loop.

    Every generated token is a job with canonical stages (read, inference,
    post_processing); an online deadline policy watches the stream and
    counts misses.
    """

    def __init__(self, model: Model, cfg: ServeConfig,
                 deadline_policy: Optional[DeadlinePolicy] = None,
                 device: str | torch.device = "cuda") -> None:
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)
        self.recorder = TimelineRecorder()
        self.policy = deadline_policy or MeanDeadline(margin=1.5)
        self.misses = 0
        self.jobs = 0
        self._step = make_serve_step(model)

    def init_state(self) -> DecodeState:
        return self.model.init_decode_state(self.cfg.batch, self.cfg.context,
                                            device=self.device)

    @torch.inference_mode()
    def generate(self, params, prompt: np.ndarray,
                 max_new_tokens: int) -> tuple[np.ndarray, TimelineRecorder]:
        """Feed the prompt (B, prompt_len) token by token (cache fill),
        then decode ``max_new_tokens`` greedily.  Returns (B, max_new_tokens)."""
        state = self.init_state()
        b, plen = prompt.shape
        if b != self.cfg.batch:
            raise ValueError(f"prompt batch {b} != engine batch {self.cfg.batch}")
        if plen < 1:
            raise ValueError(
                "prompt must contain at least one token per sequence "
                f"(got prompt_len={plen}); the decode loop is seeded from "
                "the last prompt token")

        # --- prompt phase (not latency-scored: the paper scores steady state)
        prompt_t = torch.as_tensor(np.asarray(prompt, np.int32), device=self.device)
        for t in range(plen):
            nxt, _, state = self._step(params, state, prompt_t[:, t])
        fence(nxt)

        # --- decode phase (scored after warmup; warmup steps seed the
        # deadline policy so the first scored job never meets an unseeded one)
        out = np.zeros((b, max_new_tokens), np.int32)
        cur = nxt
        for i in range(max_new_tokens):
            timer = StageTimer()
            with timer.stage("read"):
                cur = torch.as_tensor(cur, device=self.device)
            with timer.stage("inference"):
                nxt, _, state = self._step(params, state, cur)
                fence(nxt)
            with timer.stage("post_processing"):
                out[:, i] = nxt.cpu().numpy()
            rec = timer.finish()
            lat = rec.end_to_end
            if i >= self.cfg.warmup_steps:
                self.recorder.add(rec)
                self.jobs += 1
                if lat > self.policy.deadline():
                    self.misses += 1
            self.policy.observe(lat)
            cur = nxt
        return out, self.recorder

    def report(self) -> dict:
        s = self.recorder.summary()
        return {
            "mean_s": s.mean,
            "cv": s.cv,
            "range_s": s.range,
            "p99_s": s.p99,
            "jobs": self.jobs,
            "deadline_misses": self.misses,
            "miss_rate": self.misses / self.jobs if self.jobs else float("nan"),
        }
