"""Discrete-event CPU/accelerator scheduling simulator (paper §III-E).

Models the paper's runtime experiment: DNN jobs are (pre → infer → post)
stage chains where ``infer`` runs on a non-preemptive accelerator and the
host stages run on preemptive CPU cores under a pluggable policy:

* ``OTHER``    — CFS-style fair scheduling (min-vruntime next),
* ``FIFO``     — SCHED_FIFO: fixed priority, run to completion,
* ``RR``       — SCHED_RR: fixed priority, round-robin (vruntime among
                 equal priority),
* ``DEADLINE`` — SCHED_DEADLINE: EDF ordering **with CBS budget
                 throttling** — a task that exhausts its runtime budget is
                 throttled until its next period.  This is the mechanism
                 behind the paper's Insight 4: deadline scheduling shows the
                 *worst* latency variance, and a tight (mean-based) budget
                 throttles more often than a worst-observed budget.

Deterministic (seeded execution-time draws), simulated clock, no wall time —
results are exactly reproducible on any host.  A copy of the reference's
``repro/sched/simulator.py``: the port imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

__all__ = ["StageSpec", "TaskSpec", "SimConfig", "simulate", "SimResult"]


@dataclasses.dataclass(frozen=True)
class StageSpec:
    name: str
    resource: str          # "cpu" | "accel"
    mean: float            # seconds
    jitter: float = 0.1    # lognormal sigma
    # optional per-job multiplier stream (e.g. proposal-count-driven post time)
    scale_fn: Optional[Callable[[int], float]] = None


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    period: float
    stages: tuple[StageSpec, ...]
    policy: str = "OTHER"            # OTHER | FIFO | RR | DEADLINE
    priority: int = 0                # FIFO/RR: higher runs first
    deadline_budget: float = 0.0     # DEADLINE: CBS runtime budget per period
    n_jobs: int = 200
    # anytime fidelity: alternative per-rung stage chains (e.g. from a
    # calibrated ladder's stage means) and a per-job rung choice — so
    # scheduling-policy × fidelity interactions are simulable.  Without
    # ``rungs`` every job runs ``stages``.
    rungs: Optional[tuple[tuple[StageSpec, ...], ...]] = None
    rung_fn: Optional[Callable[[int], int]] = None

    def job_stages(self, job_idx: int) -> tuple[int, tuple[StageSpec, ...]]:
        """(rung index, stage chain) for job ``job_idx``."""
        if self.rungs is None:
            return 0, self.stages
        r = self.rung_fn(job_idx) if self.rung_fn is not None else 0
        if not 0 <= r < len(self.rungs):
            raise ValueError(
                f"task {self.name!r}: rung_fn({job_idx}) = {r} is outside "
                f"the {len(self.rungs)}-rung ladder"
            )
        return r, self.rungs[r]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    cpu_cores: int = 4
    seed: int = 0
    tick: float = 0.001              # preemption granularity


@dataclasses.dataclass
class SimResult:
    latencies: dict[str, np.ndarray]     # task → end-to-end per job
    throttle_events: dict[str, int]
    miss_rates: dict[str, float]         # fraction of jobs finishing > period
    rungs: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Job:
    task: TaskSpec
    idx: int
    release: float
    durations: tuple[float, ...]
    stages: tuple[StageSpec, ...] = ()
    rung: int = 0
    stage: int = 0
    remaining: float = 0.0
    vruntime: float = 0.0
    budget: float = 0.0
    period_end: float = 0.0
    throttled_until: float = 0.0
    queued_accel: bool = False
    done_at: float = -1.0

    def resource(self) -> str:
        return self.stages[self.stage].resource


# floor for sampled stage durations: a draw can go non-positive (negative
# spec.mean, or a wide-variance / Gaussian-style scale_fn emitting negative
# multipliers) and a negative duration would run the stage *backwards* —
# done_at before release, corrupted SimResult timelines, and a vruntime
# that rewards the corrupted task under CFS ordering.
_MIN_STAGE_S = 1e-6


def _draw(rng: np.random.Generator, spec: StageSpec, job: int) -> float:
    base = spec.mean * float(rng.lognormal(0.0, spec.jitter))
    if spec.scale_fn is not None:
        base *= float(spec.scale_fn(job))
    if not math.isfinite(base):
        # max() would silently propagate NaN (NaN comparisons are False),
        # and a NaN remaining-time never reaches zero — the simulator
        # would spin to its guard limit.  Fail loudly instead.
        raise ValueError(
            f"stage {spec.name!r}: sampled duration {base!r} for job {job} "
            "is not finite (check scale_fn / jitter)"
        )
    return base if base >= _MIN_STAGE_S else _MIN_STAGE_S


def simulate(tasks: list[TaskSpec],
             cfg: Optional[SimConfig] = None) -> SimResult:
    if cfg is None:
        cfg = SimConfig()
    rng = np.random.default_rng(cfg.seed)
    jobs: list[_Job] = []
    for t in tasks:
        for j in range(t.n_jobs):
            rung, stages = t.job_stages(j)
            durs = tuple(_draw(rng, s, j) for s in stages)
            jb = _Job(task=t, idx=j, release=j * t.period, durations=durs,
                      stages=stages, rung=rung)
            jb.remaining = durs[0]
            jb.budget = t.deadline_budget
            jb.period_end = jb.release + t.period
            jobs.append(jb)

    throttles = {t.name: 0 for t in tasks}
    pending = sorted(jobs, key=lambda jb: jb.release)
    live: list[_Job] = []
    finished = 0
    total = len(jobs)

    time = 0.0
    accel_current: Optional[_Job] = None
    accel_free_at = 0.0
    accel_queue: list[_Job] = []

    def advance(jb: _Job, now: float) -> None:
        nonlocal finished
        jb.stage += 1
        jb.queued_accel = False
        jb.throttled_until = 0.0
        if jb.stage >= len(jb.stages):
            jb.done_at = now
            live.remove(jb)
            finished += 1
        else:
            jb.remaining = jb.durations[jb.stage]

    guard = 0
    while finished < total:
        guard += 1
        if guard > 20_000_000:  # pragma: no cover - safety valve
            raise RuntimeError("simulator did not converge")

        while pending and pending[0].release <= time + 1e-12:
            live.append(pending.pop(0))

        # ---- accelerator (FIFO, non-preemptive) ----
        if accel_current is not None and accel_free_at <= time + 1e-12:
            advance(accel_current, accel_free_at)
            accel_current = None
        for jb in live:
            if jb.resource() == "accel" and not jb.queued_accel:
                accel_queue.append(jb)
                jb.queued_accel = True
        if accel_current is None and accel_queue:
            accel_current = accel_queue.pop(0)
            accel_free_at = time + accel_current.remaining

        # ---- CPU cores (preemptive, one tick) ----
        ready = [
            jb for jb in live
            if jb.resource() == "cpu" and jb.throttled_until <= time + 1e-12
        ]

        def key(jb: _Job):
            pol = jb.task.policy
            if pol == "FIFO":
                return (0, -jb.task.priority, jb.release, jb.idx)
            if pol == "RR":
                return (0, -jb.task.priority, jb.vruntime, jb.idx)
            if pol == "DEADLINE":
                return (0, 0, jb.period_end, jb.idx)      # EDF
            return (1, 0, jb.vruntime, jb.idx)            # OTHER (CFS-ish)

        ready.sort(key=key)
        for jb in ready[: cfg.cpu_cores]:
            step = min(cfg.tick, jb.remaining)
            jb.remaining -= step
            jb.vruntime += step
            if jb.task.policy == "DEADLINE" and jb.task.deadline_budget > 0:
                jb.budget -= step
                if jb.budget <= 0 and jb.remaining > 1e-12:
                    throttles[jb.task.name] += 1
                    jb.throttled_until = jb.period_end
                    jb.period_end += jb.task.period
                    jb.budget = jb.task.deadline_budget
            if jb.remaining <= 1e-12:
                advance(jb, time + step)

        # ---- advance clock to next interesting instant ----
        candidates = [time + cfg.tick]
        if pending:
            candidates.append(pending[0].release)
        if accel_current is not None:
            candidates.append(accel_free_at)
        time = max(min(candidates), time + 1e-9)

    lat = {}
    miss = {}
    rungs = {}
    for t in tasks:
        mine = [jb for jb in jobs if jb.task is t]
        xs = np.array([jb.done_at - jb.release for jb in mine])
        lat[t.name] = xs
        miss[t.name] = float(np.mean(xs > t.period)) if xs.size else float("nan")
        rungs[t.name] = np.array([jb.rung for jb in mine], np.int64)
    return SimResult(latencies=lat, throttle_events=throttles, miss_rates=miss,
                     rungs=rungs)
