"""Per-axis variance attribution — the paper's core question, made a
report: *which axis caused this run's latency variance?*

Given per-frame samples tagged with the serving context (rung, batch
size, scenario segment, contention level, compile activity), we
decompose ``Var(T)`` with the law of total variance applied
hierarchically.  For an ordered list of axes with grouping features
``g_1 .. g_K``, let ``G_k = (g_1, ..., g_k)`` be the joint grouping of
the first ``k`` axes.  Then

    explained_k = Var(E[T | G_k]) - Var(E[T | G_{k-1}])

is the *incremental* between-group variance axis ``k`` adds once the
axes before it are already conditioned on, and

    residual = Var(T) - Var(E[T | G_K])

is the within-cell variance no tagged feature explains — charged to the
paper's ``end_to_end`` axis (scheduling noise, untagged interference).
Increments telescope, so shares sum to 1 exactly.

Axis → feature mapping (the paper's Table I, recast onto our tags):

* ``hardware``  — contention level, binned (co-resident interference);
* ``model``     — fidelity rung (architecture / anytime ladder);
* ``data``      — scenario content + work level (input-dependent cost);
* ``io``        — effective batch size (transfer + readback width);
* ``runtime``   — compile/retrace activity on the frame's tick.

``hardware`` is deliberately ordered first: attribution is
order-dependent (correlated features fight for shared variance), and
the decomposition answers "how much variance *could* the platform have
avoided by isolating contention" — the paper's headline axis.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Hashable, Iterable, Sequence

import numpy as np

from .span import AXES

__all__ = ["FrameSample", "VariationAttribution", "attribute"]

#: Attribution order (a permutation of AXES minus the residual axis).
ATTRIBUTION_ORDER = ("hardware", "model", "data", "io", "runtime")

#: Contention multipliers are binned to this width before grouping so a
#: continuous ramp (1.0 → 1.3) forms a handful of cells, not one cell
#: per frame (which would trivially "explain" everything).
CONTENTION_BIN = 0.05

#: Work levels (scene complexity counts) are binned likewise.
WORK_BIN = 4


@dataclasses.dataclass(frozen=True)
class FrameSample:
    """One served frame with the tags attribution groups on."""

    latency_s: float
    stream: str = ""
    tick: int = 0
    segment: str = ""
    scenario: str = ""
    rung: str = ""
    batch_size: int = 0
    work: int = 0
    contention: float = 1.0
    compiles: int = 0


def _axis_features() -> dict[str, Callable[[FrameSample], Hashable]]:
    return {
        "hardware": lambda s: round(s.contention / CONTENTION_BIN),
        "model": lambda s: s.rung,
        "data": lambda s: (s.scenario, s.work // WORK_BIN),
        "io": lambda s: s.batch_size,
        "runtime": lambda s: s.compiles > 0,
    }


def _between_group_variance(latencies: np.ndarray,
                            groups: Sequence[Hashable]) -> float:
    """Var(E[T | G]) with cell means weighted by cell size."""
    sums: dict[Hashable, float] = {}
    counts: dict[Hashable, int] = {}
    for t, g in zip(latencies, groups):
        sums[g] = sums.get(g, 0.0) + float(t)
        counts[g] = counts.get(g, 0) + 1
    n = latencies.size
    grand = float(latencies.mean())
    return sum(c * (sums[g] / c - grand) ** 2
               for g, c in counts.items()) / n


@dataclasses.dataclass
class VariationAttribution:
    """Result of :func:`attribute` — per-axis variance shares."""

    n: int
    total_variance: float
    mean_latency_s: float
    explained: dict  # axis -> {"variance": v, "share": v/total, "cells": k}
    order: tuple = ATTRIBUTION_ORDER

    def share(self, axis: str) -> float:
        if axis not in AXES:
            raise ValueError(f"unknown axis {axis!r}; axes: {AXES}")
        entry = self.explained.get(axis)
        return 0.0 if entry is None else entry["share"]

    def to_dict(self) -> dict:
        return {
            "n": self.n,
            "total_variance": self.total_variance,
            "mean_latency_s": self.mean_latency_s,
            "order": list(self.order),
            "explained": {axis: dict(v) for axis, v in
                          sorted(self.explained.items())},
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def table(self) -> str:
        """Human-readable attribution table for the dashboard/README."""
        lines = [f"variance attribution over {self.n} frames "
                 f"(total var {self.total_variance:.3e} s^2, "
                 f"mean {self.mean_latency_s * 1e3:.2f} ms)",
                 f"{'axis':<12}{'share':>8}{'variance':>12}{'cells':>7}"]
        for axis in list(self.order) + ["end_to_end"]:
            e = self.explained.get(axis)
            if e is None:
                continue
            lines.append(f"{axis:<12}{e['share'] * 100:>7.1f}%"
                         f"{e['variance']:>12.3e}{e['cells']:>7d}")
        return "\n".join(lines)


def attribute(samples: Iterable[FrameSample],
              order: Sequence[str] = ATTRIBUTION_ORDER,
              ) -> VariationAttribution:
    """Hierarchical law-of-total-variance decomposition of frame latency."""
    samples = list(samples)
    feats = _axis_features()
    for axis in order:
        if axis not in feats:
            raise ValueError(f"no grouping feature for axis {axis!r}; "
                             f"available: {sorted(feats)}")
    n = len(samples)
    if n == 0:
        return VariationAttribution(0, 0.0, 0.0, {}, tuple(order))
    lat = np.asarray([s.latency_s for s in samples], dtype=np.float64)
    total = float(lat.var())
    mean = float(lat.mean())
    explained: dict[str, dict] = {}
    joint: list[tuple] = [() for _ in samples]
    prev_between = 0.0
    for axis in order:
        f = feats[axis]
        joint = [g + (f(s),) for g, s in zip(joint, samples)]
        between = _between_group_variance(lat, joint)
        inc = max(0.0, between - prev_between)  # clip float cancellation
        explained[axis] = {
            "variance": inc,
            "share": inc / total if total > 0 else 0.0,
            "cells": len(set(joint)),
        }
        prev_between = between
    residual = max(0.0, total - prev_between)
    explained["end_to_end"] = {
        "variance": residual,
        "share": residual / total if total > 0 else 0.0,
        "cells": n,
    }
    return VariationAttribution(n, total, mean, explained, tuple(order))
