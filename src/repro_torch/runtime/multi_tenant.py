"""Multi-tenant continuous-batching serving engine.

The paper's end-to-end insight (§IV) is that perception latency variance
comes from the *interaction* of concurrent DNN tasks sharing one
accelerator.  This engine makes that interaction first-class: many decode
streams are co-resident inside one fixed-capacity padded batch, joining
and leaving **without recompilation** (the TPU-native static-shape
mitigation), and every step's latency is attributed to every co-resident
stream — per-tenant ``TimelineRecorder`` instrumentation, exactly as the
paper attributes variance per stage.

Mechanics
---------
* The batch has ``capacity`` slots.  Every step runs the full padded
  batch; a stream occupies one slot.  Joining carves the slot's KV /
  recurrent state out of the static batch (zeroed in place on the
  device); leaving just returns the slot to the free list.  Shapes never
  change, so the step is built once (``compile()``, counted by
  ``trace_count``) and joins and leaves never build it again.  The step
  runs eagerly, as the port's ``Engine`` does: on the card every
  attention layer launches the ``decode_attention`` kernel.
* A joining stream's prompt is fed token-by-token through the shared
  decode step while other streams keep decoding — chunkless continuous
  prefill ("ramp").  Ramp steps seed the tenant's deadline policy but are
  not scored as jobs.
* Per-step latency is one *job* for every scored co-resident stream: your
  token took that long because of who you shared the accelerator with.
  Misses are counted per tenant against its SLO (``deadline_s``) or its
  adaptive deadline policy.

State carve-out caveat: recurrent families (RWKV6 / Mamba2) reset exactly
— their state has a per-slot batch axis and nothing else.  Attention KV
caches share the ring-buffer ``positions`` vector across slots, so a
joining stream inherits the global decode position with zeroed K/V for
its slot (stale keys contribute zero values; approximate, documented).
The port reproduces that approximation.

The port of the reference's ``repro/runtime/multi_tenant.py``: the
stage timing is one host-to-device copy of the token vector (``read``),
the step ended by ``core.timing.fence`` (``inference``), and one
device-to-host copy of the next tokens (``post_processing``), with no
per-slot readback.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..core.deadline import DeadlinePolicy, DynamicDeadline, MeanDeadline
from ..core.monitoring import BUILD_EVENT, TRACE_EVENT, record_event_duration_secs
from ..core.stats import summarize
from ..core.timing import StageTimer, TimelineRecorder, fence, to_host
from ..models import DecodeState, Model
from ..perception.detector import resolve_device

from .admission import (
    ADMIT,
    DEFER,
    AdmissionController,
    AlwaysAdmit,
    AnytimeAdmission,
)
from .engine import make_serve_step
from .queue import RequestQueue, StreamRequest

__all__ = ["MultiTenantConfig", "TenantState", "MultiTenantEngine"]


@dataclasses.dataclass(frozen=True)
class MultiTenantConfig:
    capacity: int                  # static padded batch slots
    context: int
    warmup_steps: int = 2          # engine steps before any job is scored

    def __post_init__(self) -> None:
        if self.capacity < 1:
            raise ValueError(
                f"capacity must be >= 1 (got {self.capacity}): a zero-slot "
                "engine would silently strand every queued request"
            )
        if self.context < 1:
            raise ValueError(f"context must be >= 1 (got {self.context})")


def _default_policy(req: StreamRequest) -> DeadlinePolicy:
    pol = MeanDeadline(margin=1.5)
    return pol


@dataclasses.dataclass
class TenantState:
    """One seated stream: slot, ramp progress, per-tenant instrumentation."""

    req: StreamRequest
    slot: int
    joined_at: float
    policy: DeadlinePolicy
    pending_prompt: deque = dataclasses.field(default_factory=deque)
    generated: list = dataclasses.field(default_factory=list)
    recorder: TimelineRecorder = dataclasses.field(default_factory=TimelineRecorder)
    jobs: int = 0
    misses: int = 0
    ramp_steps: int = 0
    finished_at: Optional[float] = None

    @property
    def in_ramp(self) -> bool:
        return bool(self.pending_prompt)

    def effective_deadline(self) -> float:
        if self.req.deadline_s is not None:
            return self.req.deadline_s
        return self.policy.deadline()

    def report(self) -> dict:
        s = summarize(self.recorder.end_to_end_series()) if self.recorder.records else None
        row = self.shed_row(self.req)
        row.update(
            status="finished" if self.finished_at is not None else "active",
            jobs=self.jobs,
            ramp_steps=self.ramp_steps,
            misses=self.misses,
            miss_rate=self.misses / self.jobs if self.jobs else float("nan"),
            tokens=len(self.generated),
        )
        if s is not None:
            row.update(mean_s=s.mean, cv=s.cv, p99_s=s.p99)
        return row

    @staticmethod
    def shed_row(req: StreamRequest) -> dict:
        """Report row for a stream that was never seated — the one schema
        both seated and shed rows share (``report`` builds on it)."""
        return {
            "tenant": req.tenant, "status": "shed", "jobs": 0,
            "ramp_steps": 0, "mean_s": float("nan"), "cv": float("nan"),
            "p99_s": float("nan"), "misses": 0,
            "miss_rate": float("nan"), "tokens": 0,
        }


class MultiTenantEngine:
    """Fixed-capacity continuous-batching decode engine with deadline-aware
    admission control and per-tenant variance attribution.  ``params`` are
    the model's weights on ``device`` (the card unless ``"cpu"`` is asked
    for)."""

    def __init__(
        self,
        model: Model,
        params,
        cfg: MultiTenantConfig,
        admission: Optional[AdmissionController | AlwaysAdmit] = None,
        policy_factory: Callable[[StreamRequest], DeadlinePolicy] = _default_policy,
        anytime: bool = False,
        obs=None,
        obs_tag: str = "decode",
        device: str | torch.device = "cuda",
    ) -> None:
        self.model = model
        self.params = params
        self.cfg = cfg
        self.admission = admission if admission is not None else AlwaysAdmit()
        if anytime:
            # anytime mode: degradation (SLO relaxation down the request's
            # declared service ladder) is attempted before admission-shedding
            if isinstance(self.admission, AdmissionController):
                self.admission = AnytimeAdmission(self.admission)
            elif not isinstance(self.admission, AnytimeAdmission):
                raise ValueError(
                    "anytime=True needs a shedding admission controller to "
                    f"degrade around (got {type(self.admission).__name__}); "
                    "an always-admit engine never sheds, so there is "
                    "nothing to rescue"
                )
        self.policy_factory = policy_factory
        # observability: a ``repro_torch.obs.Observatory`` (duck-typed).  The
        # shared decode step emits stage spans under ``obs_tag``; every
        # scored tenant additionally feeds a per-tenant metrics key, and
        # admission decisions land as instants on the runtime axis.
        self.obs = obs
        self.obs_tag = obs_tag

        self.device = resolve_device(device)
        # builds of the shared step: compile() makes the one build, and
        # joins and leaves never make another (the static-shape contract)
        self.trace_count = 0
        self._step = make_serve_step(model)

        with torch.inference_mode():
            self._state: DecodeState = model.init_decode_state(cfg.capacity, cfg.context,
                                                               device=self.device)
        self._tokens = np.zeros(cfg.capacity, np.int32)
        # deque: admissions pop the head and departures push the tail on the
        # hot path — list.pop(0) was O(capacity) churn per seat
        self._free: deque[int] = deque(range(cfg.capacity))
        self.active: dict[int, TenantState] = {}
        self.finished: list[TenantState] = []
        self.shed: list[StreamRequest] = []
        self.steps = 0
        self.step_log: list[tuple[int, float]] = []   # (n_active, latency)
        self._compiled = False

    # ---------------- slot state carve-out ----------------
    @staticmethod
    @torch.inference_mode()
    def _zero_slot(state: DecodeState, slot: int) -> DecodeState:
        """Zero one slot's entries along the batch axis (axis 1) of every
        state component, in place on the state's device; shared KV-cache
        bookkeeping (``positions``, ``next_pos``) is untouched."""
        leaves = []
        if state.kv is not None:
            leaves += [state.kv.k, state.kv.v]
        for part in (state.ssm, state.rwkv):
            if part is not None:
                leaves += list(part)
        for leaf in leaves:
            leaf[:, slot].zero_()
        return state

    # ---------------- join / leave ----------------
    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def join(self, req: StreamRequest, now: float = 0.0) -> TenantState:
        """Seat a stream in a free slot (no admission check — that is
        ``admit_from``'s job).  Raises if the batch is full."""
        if not self._free:
            raise RuntimeError(
                f"no free slot (capacity {self.cfg.capacity}, "
                f"{self.n_active} active)"
            )
        slot = self._free.popleft()
        self._state = self._zero_slot(self._state, slot)
        policy = self.policy_factory(req)
        if isinstance(policy, DynamicDeadline):
            policy.set_criticality(req.criticality)
        ts = TenantState(
            req=req,
            slot=slot,
            joined_at=now,
            policy=policy,
            pending_prompt=deque(int(t) for t in req.prompt[1:]),
        )
        self._tokens[slot] = int(req.prompt[0])
        self.active[slot] = ts
        return ts

    def leave(self, slot: int, now: float = 0.0) -> TenantState:
        ts = self.active.pop(slot)
        ts.finished_at = now
        self._tokens[slot] = 0
        self._free.append(slot)
        self.finished.append(ts)
        return ts

    def admit_from(self, queue: RequestQueue, now: float = 0.0) -> int:
        """Pop the queue into free slots under the admission policy.
        Head-of-line defer blocks the queue (FIFO fairness).  Returns the
        number of streams seated; ``self.shed`` records the rejects."""
        seated = 0
        while self._free and queue:
            req = queue.pop()
            decision = self.admission.decide(req, self.n_active, now)
            if self.obs is not None:
                self.obs.tracer.instant(
                    decision.action, stream=req.tenant, tick=self.steps,
                    batch_size=self.n_active, axis="runtime")
            if decision.action == ADMIT:
                # the anytime path may admit a degraded-SLO replacement;
                # seat the request the decision actually granted
                self.join(decision.request if decision.request is not None else req, now)
                seated += 1
            elif decision.action == DEFER:
                queue.requeue(req)
                break
            else:   # SHED
                self.shed.append(req)
        return seated

    # ---------------- stepping ----------------
    @torch.inference_mode()
    def compile(self) -> None:
        """Build the serve step: one warm-up call on a scratch state of the
        engine's shape (kernels loaded, library handles made), so the first
        real step is not a set-up outlier and the live state is untouched.
        Idempotent."""
        if self._compiled:
            return
        t0 = time.perf_counter()
        scratch = self.model.init_decode_state(self.cfg.capacity, self.cfg.context,
                                               device=self.device)
        toks = torch.zeros(self.cfg.capacity, dtype=torch.int32, device=self.device)
        nxt, _, _ = self._step(self.params, scratch, toks)
        fence(nxt)
        del scratch
        self.trace_count += 1
        # the warm-up call is the build: one trace and one build event
        record_event_duration_secs(TRACE_EVENT, time.perf_counter() - t0)
        record_event_duration_secs(BUILD_EVENT, time.perf_counter() - t0)
        self._compiled = True

    @torch.inference_mode()
    def step(self, now: float = 0.0) -> Optional[float]:
        """One shared decode step over the full padded batch.  Returns the
        measured step latency, or None if no stream is seated."""
        if not self.active:
            return None
        self.compile()
        n_active = self.n_active

        if self.obs is not None:
            timer = StageTimer(
                tracer=self.obs.tracer,
                tags={"stream": self.obs_tag, "tick": self.steps,
                      "batch_size": n_active})
        else:
            timer = StageTimer()
        with timer.stage("read"):
            toks = torch.from_numpy(self._tokens).to(self.device)
        with timer.stage("inference"):
            nxt, _, self._state = self._step(self.params, self._state, toks)
            fence(nxt)
        with timer.stage("post_processing"):
            host = to_host(nxt)
            done: list[int] = []
            decode_slots: list[int] = []
            for slot, ts in self.active.items():
                if ts.pending_prompt:
                    # ramp: the output belongs to a prompt position; feed
                    # the next prompt token instead
                    ts.ramp_steps += 1
                    self._tokens[slot] = ts.pending_prompt.popleft()
                else:
                    # a pure decode step for this stream only once it has a
                    # first token; the step that consumed the last prompt
                    # token produces generated[0] but is still ramp (the
                    # single-tenant engine likewise never scores the
                    # prompt phase)
                    if ts.generated:
                        decode_slots.append(slot)
                    else:
                        ts.ramp_steps += 1
                    tok = int(host[slot])
                    ts.generated.append(tok)
                    self._tokens[slot] = tok
                    if len(ts.generated) >= ts.req.max_new_tokens:
                        done.append(slot)
        rec = timer.finish()
        rec.meta["n_active"] = float(n_active)
        lat = rec.end_to_end

        self.steps += 1
        self.step_log.append((n_active, lat))
        self.admission.observe_step(n_active, lat)

        scored = self.steps > self.cfg.warmup_steps
        for slot, ts in self.active.items():
            # score against the deadline as it stood *before* this step,
            # then observe (same order as Engine.generate — observing first
            # would inflate an adaptive deadline with the very latency it
            # is judging); ramp and warmup steps seed without being scored
            if scored and slot in decode_slots:
                ts.recorder.add(rec)
                ts.jobs += 1
                if lat > ts.effective_deadline():
                    ts.misses += 1
                if self.obs is not None:
                    # per-tenant attribution of the shared step: your token
                    # took this long because of who you shared the batch with
                    self.obs.metrics.observe(ts.req.tenant, "step", lat,
                                             batch_size=n_active)
            ts.policy.observe(lat)
        for slot in done:
            self.leave(slot, now)
        return lat

    def drain(
        self,
        queue: RequestQueue,
        clock=None,
        source=None,
        max_steps: int = 100_000,
        on_step: Optional[Callable[[int], None]] = None,
    ) -> int:
        """Run until the queue, the batch, and any in-flight arrivals are
        all empty.  If ``clock`` is given (``bus.SimClock``), each measured
        step latency advances simulated time and admissions use it as
        ``now``.  ``source`` is an optional arrival feed with the broker's
        interface (``deliver_until(t)`` pushing into ``queue`` via its
        subscription, ``next_delivery()``): deliveries due by the clock are
        flushed before each admission round, and an idle engine
        fast-forwards the clock to the next arrival instead of exiting.
        ``on_step(steps)`` is called after every engine step — the hook
        the ``--obs`` serving dashboard renders from."""
        if source is not None and clock is None:
            raise ValueError(
                "drain(source=...) needs a clock: arrivals are stamped on "
                "simulated time, and without one the loop could exit while "
                "deliveries are still in flight"
            )
        steps = spins = 0
        while True:
            spins += 1
            if spins >= 2 * max_steps:
                raise RuntimeError("drain did not converge")
            now = clock.time() if clock is not None else 0.0
            if source is not None:
                source.deliver_until(now)
            self.admit_from(queue, now)
            if not self.active:
                nxt = source.next_delivery() if source is not None else None
                if nxt is not None and clock is not None:
                    clock.advance_to(nxt)    # idle until the next arrival
                    continue
                break   # nothing seated, nothing in flight
            lat = self.step(now)
            if clock is not None:
                clock.advance(lat)
            steps += 1
            if on_step is not None:
                on_step(steps)
            if steps >= max_steps:
                raise RuntimeError("drain did not converge")
        return steps

    # ---------------- reporting ----------------
    def per_tenant_report(self) -> list[dict]:
        rows = [ts.report() for ts in self.finished]
        rows += [ts.report() for ts in self.active.values()]
        rows += [TenantState.shed_row(req) for req in self.shed]
        rows.sort(key=lambda r: r["tenant"])
        return rows

    def aggregate_report(self) -> dict:
        tenants = self.finished + list(self.active.values())
        jobs = sum(t.jobs for t in tenants)
        misses = sum(t.misses for t in tenants)
        lats = np.asarray([lat for _, lat in self.step_log])
        s = summarize(lats) if lats.size else None
        return {
            "steps": self.steps,
            "streams": len(tenants),
            "shed_streams": len(self.shed),
            "degraded_streams": getattr(self.admission, "degraded", 0),
            "jobs": jobs,
            "misses": misses,
            "miss_rate": misses / jobs if jobs else float("nan"),
            "step_mean_s": s.mean if s else float("nan"),
            "step_cv": s.cv if s else float("nan"),
            "step_p99_s": s.p99 if s else float("nan"),
            "traces": self.trace_count,
        }
