"""Analytic cross-check for the multi-tenant contention curve (copied
from the reference's ``repro/sched/contention.py``).

The multi-tenant engine measures CV / p99 versus co-resident streams on
the real device; this module builds the matching discrete-event
scenario for ``sched.simulate`` (paper §III-E): N periodic inference tasks
whose ``infer`` stages serialize on one non-preemptive accelerator while
pre/post stages share the CPU cores.  The simulated curve shows the same
shape — tail latency grows superlinearly with co-residency — without any
real compute, which separates the *queueing* contribution to contention
from the *batch-compute* contribution the engine measures.
"""
from __future__ import annotations

import numpy as np

from .simulator import SimConfig, SimResult, StageSpec, TaskSpec, simulate

__all__ = ["contention_tasks", "contention_curve"]


def contention_tasks(
    n_streams: int,
    infer_mean: float = 0.010,
    host_mean: float = 0.002,
    period: float = 0.033,
    jitter: float = 0.15,
    n_jobs: int = 120,
    policy: str = "OTHER",
) -> list[TaskSpec]:
    """N identical perception-style (pre → infer → post) tasks contending
    for one accelerator — the co-residency the engine realizes in slots."""
    stages = (
        StageSpec("pre_processing", "cpu", host_mean, jitter),
        StageSpec("inference", "accel", infer_mean, jitter),
        StageSpec("post_processing", "cpu", host_mean, jitter),
    )
    return [
        TaskSpec(
            name=f"stream-{i:02d}",
            period=period,
            stages=stages,
            policy=policy,
            n_jobs=n_jobs,
        )
        for i in range(n_streams)
    ]


def contention_curve(
    stream_counts: list[int] | tuple[int, ...] = (1, 2, 4, 8),
    seed: int = 0,
    **task_kwargs,
) -> list[dict]:
    """Simulated CV / p99 / miss-rate versus number of co-resident
    streams.  One row per stream count, aggregated over all streams."""
    rows = []
    for n in stream_counts:
        res: SimResult = simulate(
            contention_tasks(n, **task_kwargs), SimConfig(seed=seed)
        )
        xs = np.concatenate([res.latencies[k] for k in sorted(res.latencies)])
        mean = float(np.mean(xs))
        rows.append(
            {
                "streams": n,
                "mean_s": mean,
                "cv": float(np.std(xs) / mean) if mean else float("nan"),
                "p99_s": float(np.percentile(xs, 99)),
                "miss_rate": float(np.mean(list(res.miss_rates.values()))),
            }
        )
    return rows
