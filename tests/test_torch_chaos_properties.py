"""Property tests for the port's chaos plan compiler and health machine,
mirroring ``tests/test_chaos_properties.py`` and holding each case
against the reference as well:

* **compile determinism** — the same (spec, streams, n_ticks, seed)
  always compiles to a byte-identical ``FaultPlan``, the reference's
  bytes; every event lands inside the horizon and targets a known stream;
* **serialization closure** — ``from_json(to_json(plan))`` is the
  identity on the serialized form;
* **health-machine safety** — under any fault/clean/age sequence a
  stream only reaches ``quarantined`` after at least
  ``quarantine_faults`` faults, ``recover`` is only reported from the
  degraded state with a non-negative ticks-to-healthy, and every verdict
  and state is the reference's.

The seeded tests always run; the hypothesis variants draw more cases."""
import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import chaos as rchaos  # noqa: E402

from repro_torch.chaos import (  # noqa: E402
    KINDS,
    ChaosSpec,
    FaultClause,
    FaultPlan,
    FleetResilience,
    ResilienceConfig,
    compile_plan,
)

_STREAMS = ("cam_front", "cam_left", "cam_right", "cam_rear")


def _random_clause_kw(rng: random.Random) -> dict:
    kind = rng.choice(KINDS)
    kw = dict(kind=kind, at=rng.randrange(0, 20), duration=rng.randrange(1, 8),
              probability=rng.choice((1.0, 0.7, 0.4)))
    if kind == "shard_loss":
        kw["shard"] = rng.randrange(0, 4)
        kw["probability"] = 1.0
        if rng.random() < 0.3:
            kw["duration"] = 0              # permanent loss
    elif kind in ("sensor_stall", "nan_frame"):
        kw["streams"] = tuple(sorted(rng.sample(_STREAMS, rng.randrange(1, 4)))) \
            if rng.random() < 0.7 else ("*",)
    elif kind == "latency_spike":
        kw["scale"] = rng.choice((1.5, 3.0, 8.0))
    elif kind == "step_fault":
        kw["count"] = rng.randrange(1, 4)
    return kw


def _random_specs(rng: random.Random):
    """The same random spec built from the port's classes and the
    reference's."""
    name = f"spec-{rng.randrange(1 << 16)}"
    kws = [_random_clause_kw(rng) for _ in range(rng.randrange(1, 6))]
    return (ChaosSpec(name, "generated", tuple(FaultClause(**kw) for kw in kws)),
            rchaos.ChaosSpec(name, "generated", tuple(rchaos.FaultClause(**kw) for kw in kws)))


def _check_plan_invariants(specs, n_ticks: int, seed: int) -> None:
    spec, rspec = specs
    a = compile_plan(spec, _STREAMS, n_ticks, seed)
    b = compile_plan(spec, _STREAMS, n_ticks, seed)
    assert a.to_json() == b.to_json()
    assert a.to_json() == rchaos.compile_plan(rspec, _STREAMS, n_ticks, seed).to_json()
    assert FaultPlan.from_json(a.to_json()).to_json() == a.to_json()
    for e in a.events:
        assert 0 <= e.tick < n_ticks
        if e.kind in ("stall", "nan_frame"):
            assert e.stream in _STREAMS
    assert a.events == sorted(a.events, key=lambda e: (e.tick, e.kind, e.stream, e.shard))


def _check_health_invariants(cfg: dict, ops) -> None:
    res = FleetResilience(ResilienceConfig(**cfg))
    ref = rchaos.FleetResilience(rchaos.ResilienceConfig(**cfg))
    sid = "cam_front"
    faults = 0
    for tick, op in enumerate(ops):
        if op == 0:
            action = res.note_fault(sid, tick)
            assert action == ref.note_fault(sid, tick)
            faults += 1
            assert action in ("degrade", "quarantine")
            if action == "quarantine":
                assert faults >= cfg["quarantine_faults"]
        elif op == 1:
            before = res.state(sid)
            healthy_after = res.note_clean(sid, tick)
            assert healthy_after == ref.note_clean(sid, tick)
            if healthy_after is not None:
                assert before == "degraded"
                assert healthy_after >= 0
                faults = 0
        else:
            assert res.age_quarantine(tick) == ref.age_quarantine(tick)
        assert res.state(sid) in ("healthy", "degraded", "quarantined")
        assert res.to_dict() == ref.to_dict()


# ----------------------------------------------- seeded, always on -----

def test_compile_plan_invariants_seeded():
    for trial in range(40):
        rng = random.Random(1000 + trial)
        _check_plan_invariants(_random_specs(rng), n_ticks=rng.randrange(1, 40),
                               seed=rng.randrange(1 << 20))


def test_health_machine_invariants_seeded():
    for trial in range(40):
        rng = random.Random(2000 + trial)
        cfg = dict(quarantine_faults=rng.randrange(1, 5), probation_ticks=rng.randrange(1, 4),
                   recover_ticks=rng.randrange(1, 4))
        _check_health_invariants(cfg, [rng.randrange(3) for _ in range(60)])


# ----------------------------------------------------- hypothesis -----

@st.composite
def specs(draw):
    return _random_specs(random.Random(draw(st.integers(0, 2**30))))


@given(specs(), st.integers(1, 40), st.integers(0, 2**20))
@settings(max_examples=50, deadline=None)
def test_compile_plan_invariants(specs, n_ticks, seed):
    _check_plan_invariants(specs, n_ticks, seed)


@given(st.integers(1, 5), st.integers(1, 4), st.integers(1, 4),
       st.lists(st.integers(0, 2), max_size=80))
@settings(max_examples=50, deadline=None)
def test_health_machine_invariants(qf, pt, rt, ops):
    _check_health_invariants(dict(quarantine_faults=qf, probation_ticks=pt, recover_ticks=rt),
                             ops)
