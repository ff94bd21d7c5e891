"""The port's chaos package (``repro_torch.chaos``) and the scheduler's
resilience hooks against the JAX reference, on the CPU.

Plans are pure Python and NumPy, so every spec must compile to the
reference's plan JSON byte for byte.  Replays bridge the reference's
seed-7 detector weights through ``params=`` (as
``tests/test_torch_scenarios.py`` does): the port's ``sensor_stall_storm``
and a one-shard shard loss then give the reference's ledger event for
event — (tick, kind, stream, shard, detail) equal, ``value`` within 1e-9
relative — and its report on every count, rung histogram and modeled
latency exactly, ``mean_quality`` within 5e-4 (measured on the plain
replays: 2.0e-8).  The reference's own byte checks against
``tests/golden`` fail in the reference, so the fault-free check holds a
replay with an empty plan attached byte-equal to the port's plain replay,
and both against a live reference replay.
"""
import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.batched.executor as rexecutor  # noqa: E402
import repro.batched.scheduler as rscheduler  # noqa: E402
from repro import chaos as rchaos  # noqa: E402
from repro.batched.scheduler import RungBucketScheduler as RScheduler  # noqa: E402
from repro.bus.clock import SimClock as RSimClock  # noqa: E402
from repro.obs import Observatory as RObservatory  # noqa: E402
from repro.perception import data as rdata  # noqa: E402
from repro.perception import detector as rdet  # noqa: E402
from repro.scenarios import catalog as rcatalog  # noqa: E402
from repro.scenarios import replay as rreplay  # noqa: E402
from repro.scenarios import trace as rtrace  # noqa: E402

from repro_torch import chaos  # noqa: E402
from repro_torch.batched import RungBucketScheduler  # noqa: E402
from repro_torch.bus import SimClock  # noqa: E402
from repro_torch.chaos import (  # noqa: E402
    CHAOS_CATALOG,
    ChaosLedger,
    ChaosSpec,
    FaultClause,
    FaultInjector,
    FaultPlan,
    FleetResilience,
    ResilienceConfig,
    compile_plan,
    corrupt_frame,
    get_chaos_episode,
    run_chaos_episode,
)
from repro_torch.chaos.__main__ import main as chaos_main  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.obs import Observatory  # noqa: E402
from repro_torch.perception import SceneConfig, generate_scene  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    ModeledStageCost,
    ScenarioReplayer,
    Tolerance,
    compare_reports,
    compile_trace,
    get_episode,
    replay_ladder,
)
from repro_torch.scenarios.golden import GOLDEN_CAPACITY, GOLDEN_EPISODES, \
    GOLDEN_TICK_SCALE  # noqa: E402

QUALITY_TOL = 5e-4
VALUE_REL = 1e-9
EXACT = Tolerance(rel=0.0, abs_ms=0.0, rate=0.0, quality=QUALITY_TOL, count_frac=0.0,
                  count_abs=0)
STREAMS = ("cam_front", "cam_left", "cam_right")

# a probabilistic mix of every clause kind (tests/test_chaos.py's _FLAKY_SPEC)
_MIXED = dict(
    name="flaky", description="probabilistic mix",
    clauses=(
        dict(kind="sensor_stall", at=2, duration=6, probability=0.5),
        dict(kind="nan_frame", at=1, duration=8, streams=("cam_front",), probability=0.4),
        dict(kind="step_fault", at=4, duration=3, count=2, probability=0.6),
        dict(kind="latency_spike", at=3, duration=4, scale=2.5),
        dict(kind="shard_loss", at=5, duration=4, shard=1),
    ))


def _specs(mod, d):
    return mod.ChaosSpec(d["name"], d["description"],
                         tuple(mod.FaultClause(**c) for c in d["clauses"]))


@pytest.fixture(scope="module")
def ref_params():
    key = jax.random.PRNGKey(7)
    tree = lambda det: jax.tree.map(np.asarray, det.init(key))  # noqa: E731
    one = tree(rdet.OneStageDetector())
    return {"one_stage": one, "early_exit": one, "two_stage": tree(rdet.TwoStageDetector())}


@pytest.fixture(scope="module")
def pool(ref_params):
    """One port scheduler on the reference's weights and one reference
    scheduler, each shared by every replay of this module (a replay resets
    the scheduler it is given, resilience included)."""
    return {"port": RungBucketScheduler(replay_ladder(), capacity=GOLDEN_CAPACITY, device="cpu",
                                        params=ref_params),
            "ref": RScheduler(rreplay.replay_ladder(), capacity=GOLDEN_CAPACITY)}


def _ledger_rows(events):
    return [(e.tick, e.kind, e.stream, e.shard, e.detail) for e in events]


def _assert_same_ledger(got, want):
    assert _ledger_rows(got) == _ledger_rows(want)
    for a, b in zip(got, want):
        assert a.value == pytest.approx(b.value, rel=VALUE_REL, abs=0.0), (a, b)


def _assert_same_report(got: dict, want: dict):
    """compare_reports with no band but mean_quality's, and the chaos blocks
    equal (values within VALUE_REL)."""
    gc, wc = got.pop("chaos", None), want.pop("chaos", None)
    assert compare_reports(got, want, EXACT) == []
    assert (gc is None) == (wc is None)
    if wc is not None:
        assert gc["counts"] == wc["counts"] and gc["recovery_ticks"] == wc["recovery_ticks"]
        assert [{k: v for k, v in e.items() if k != "value"} for e in gc["events"]] == \
            [{k: v for k, v in e.items() if k != "value"} for e in wc["events"]]
        assert [e.get("value", 0.0) for e in gc["events"]] == pytest.approx(
            [e.get("value", 0.0) for e in wc["events"]], rel=VALUE_REL, abs=0.0)


# ------------------------------------------------------------------ plans --
def _catalog_plan(mod, name, seed):
    ep = mod.get_chaos_episode(name)
    trace = (compile_trace if mod is chaos else rtrace.compile_trace)(
        (get_episode if mod is chaos else rcatalog.get_episode)(ep.base), seed=seed,
        tick_scale=ep.tick_scale)
    return mod.compile_plan(ep.spec, trace.streams, trace.n_ticks, seed)


@pytest.mark.parametrize("seed", [0, 5, 7, 12345])
@pytest.mark.parametrize("name", ["sensor_stall_storm", "shard_loss_rush_hour", "mixed"])
def test_plan_json_is_the_reference_s(name, seed):
    if name == "mixed":
        got = compile_plan(_specs(chaos, _MIXED), STREAMS, 12, seed)
        want = rchaos.compile_plan(_specs(rchaos, _MIXED), STREAMS, 12, seed)
    else:
        got, want = _catalog_plan(chaos, name, seed), _catalog_plan(rchaos, name, seed)
    assert got.to_json() == want.to_json()
    assert got.to_json(indent=2) == want.to_json(indent=2)
    assert FaultPlan.from_json(want.to_json()).to_json() == want.to_json()
    assert (got.kills, got.revives, got.stalls, got.nans, got.step_faults, got.latency) == \
        (want.kills, want.revives, want.stalls, want.nans, want.step_faults, want.latency)


def test_catalog_is_the_reference_s():
    assert chaos.chaos_episode_names() == rchaos.chaos_episode_names()
    for name, ep in CHAOS_CATALOG.items():
        r = rchaos.CHAOS_CATALOG[name]
        assert (ep.description, ep.base, ep.seed, ep.mesh_data, ep.capacity, ep.tick_scale) == \
            (r.description, r.base, r.seed, r.mesh_data, r.capacity, r.tick_scale)
        assert ep.spec.to_dict() == r.spec.to_dict()
    assert chaos.KINDS == rchaos.KINDS and chaos.__all__ == rchaos.__all__
    with pytest.raises(KeyError, match="unknown chaos episode"):
        get_chaos_episode("nope")


def test_plan_file_round_trip_reads_the_reference_s(tmp_path):
    want = rchaos.compile_plan(_specs(rchaos, _MIXED), STREAMS, 12, seed=3)
    want.save(tmp_path / "ref.json")
    got = FaultPlan.load(tmp_path / "ref.json")
    got.save(tmp_path / "port.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert ChaosSpec.from_dict(_specs(rchaos, _MIXED).to_dict()) == _specs(chaos, _MIXED)
    assert FaultPlan.empty().to_json() == rchaos.FaultPlan.empty().to_json()


_BAD_CLAUSES = [dict(kind="gremlins", at=0), dict(kind="sensor_stall", at=-1),
                dict(kind="sensor_stall", at=0, duration=-2),
                dict(kind="sensor_stall", at=0, duration=0),
                dict(kind="nan_frame", at=0, probability=0.0),
                dict(kind="nan_frame", at=0, probability=1.5),
                dict(kind="latency_spike", at=0, scale=0.0),
                dict(kind="step_fault", at=0, count=0),
                dict(kind="shard_loss", at=0, shard=-1)]


@pytest.mark.parametrize("kw", _BAD_CLAUSES, ids=lambda kw: f"{kw['kind']}-{len(kw)}")
def test_clause_validation_errors_are_the_reference_s(kw):
    with pytest.raises(ValueError) as got:
        FaultClause(**kw)
    with pytest.raises(ValueError) as want:
        rchaos.FaultClause(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(watchdog_scale=1.0), dict(max_retries=-1),
                                dict(backoff_base_s=0.0), dict(quarantine_faults=0),
                                dict(probation_ticks=0), dict(recover_ticks=0)],
                         ids=lambda kw: next(iter(kw)))
def test_resilience_config_errors_are_the_reference_s(kw):
    with pytest.raises(ValueError) as got:
        ResilienceConfig(**kw)
    with pytest.raises(ValueError) as want:
        rchaos.ResilienceConfig(**kw)
    assert str(got.value) == str(want.value)
    assert vars(ResilienceConfig()) == vars(rchaos.ResilienceConfig())


# ---------------------------------------------------- health machines ------
@pytest.mark.parametrize("trial", range(6))
def test_health_machine_follows_the_reference_s_states(trial):
    """One random call script (faults, clean ticks, quarantine ageing,
    step-fault arming and taking) on both: every return value and every
    state after each call equal."""
    rng = random.Random(300 + trial)
    cfg = dict(quarantine_faults=rng.randrange(1, 5), probation_ticks=rng.randrange(1, 4),
               recover_ticks=rng.randrange(1, 4))
    got, want = FleetResilience(ResilienceConfig(**cfg)), \
        rchaos.FleetResilience(rchaos.ResilienceConfig(**cfg))
    for tick in range(120):
        sid = rng.choice(STREAMS)
        op = rng.randrange(5)
        if op == 0:
            calls = [(r.note_fault, (sid, tick)) for r in (got, want)]
        elif op == 1:
            calls = [(r.note_clean, (sid, tick)) for r in (got, want)]
        elif op == 2:
            calls = [(r.age_quarantine, (tick,)) for r in (got, want)]
        elif op == 3:
            n = rng.randrange(0, 3)
            calls = [(r.arm_step_faults, (n,)) for r in (got, want)]
        else:
            calls = [(r.take_step_fault, ()) for r in (got, want)]
        (fa, aa), (fb, ab) = calls
        assert fa(*aa) == fb(*ab), (tick, op)
        assert got.to_dict() == want.to_dict() and got.armed == want.armed
        assert {s: vars(h) for s, h in got.health.items()} == \
            {s: vars(h) for s, h in want.health.items()}
        assert [got.state(s) for s in STREAMS] == [want.state(s) for s in STREAMS]


# ----------------------------------------------------------- injector ------
def _scene_pair(i, sid_seed):
    cfg = dict(scenario=("city", "road", "residential")[i % 3], rain_mm_per_hour=4.0 * (i % 2),
               seed=sid_seed)
    return generate_scene(SceneConfig(**cfg), i), rdata.generate_scene(rdata.SceneConfig(**cfg), i)


def test_corrupt_frame_is_the_reference_s():
    got, want = _scene_pair(3, 11)
    a, b = corrupt_frame(got), rchaos.corrupt_frame(want)
    np.testing.assert_array_equal(a.image, b.image)       # NaNs at the same pixels
    assert not np.all(np.isfinite(a.image)) and np.all(np.isfinite(got.image))
    assert a.scenario == b.scenario and a.rain == b.rain
    np.testing.assert_array_equal(a.boxes, b.boxes)


def test_filter_scenes_and_pre_tick_are_the_reference_s():
    """The same plan through both injectors: the same frames kept, in the
    caller's order, the same corrupt payloads, the same ledger; pre_tick
    drives kill/revive/arm on a recording scheduler identically."""
    spec = {**_MIXED, "clauses": _MIXED["clauses"] + (
        dict(kind="sensor_stall", at=0, duration=2, streams=("cam_left",)),
        dict(kind="nan_frame", at=0, duration=1, streams=("cam_right",)))}
    got_inj = FaultInjector(compile_plan(_specs(chaos, spec), STREAMS, 12, seed=4))
    want_inj = rchaos.FaultInjector(rchaos.compile_plan(_specs(rchaos, spec), STREAMS, 12, seed=4))

    class Recorder:
        def __init__(self, res):
            self.resilience, self.calls = res, []

        def kill_shard(self, shard):
            self.calls.append(("kill", shard))

        def revive_shard(self, shard):
            self.calls.append(("revive", shard))

    got_sched, want_sched = Recorder(FleetResilience()), Recorder(rchaos.FleetResilience())
    for tick in range(12):
        pairs = {sid: _scene_pair(tick, 20 + i) for i, sid in enumerate(STREAMS)}
        a = got_inj.filter_scenes(tick, {s: p[0] for s, p in pairs.items()})
        b = want_inj.filter_scenes(tick, {s: p[1] for s, p in pairs.items()})
        assert list(a) == list(b)
        for sid in a:
            np.testing.assert_array_equal(a[sid].image, b[sid].image)
        got_inj.pre_tick(tick, got_sched)
        want_inj.pre_tick(tick, want_sched)
        assert got_inj.latency_scale(tick) == want_inj.latency_scale(tick)
    assert got_sched.calls == want_sched.calls and got_sched.calls
    assert got_sched.resilience.armed == want_sched.resilience.armed > 0
    _assert_same_ledger(got_inj.ledger.events, want_inj.ledger.events)
    assert got_inj.ledger.to_dict() == want_inj.ledger.to_dict()


def test_ledger_summaries_and_obs_fanout_are_the_reference_s():
    """The ledger and its summaries are the reference's.  Its obs fan-out
    is not: the reference passes ``detail=`` to ``tracer.instant``, whose
    spans have no such field, so it raises TypeError with an observatory
    attached; the port records the instant without the detail, and the
    span equals the reference tracer's instant of the same tags."""
    tobs, robs = Observatory(), RObservatory()
    tclock, rclock = SimClock(), RSimClock()
    tobs.bind_clock(tclock)
    robs.bind_clock(rclock)
    got, want = ChaosLedger(obs=tobs), rchaos.ChaosLedger()
    script = [(2, "fault_inject", "kill shard 0", "", 0, 0.0),
              (2, "degrade", "evacuation", "cam_left", 0, 0.0),
              (3, "failover", "re-seated", "cam_left", -1, 0.0),
              (5, "recover", "healthy after 2 ticks degraded", "cam_left", -1, 2.0),
              (6, "watchdog", "latency", "cam_front", -1, 0.0315)]
    for tick, kind, detail, stream, shard, value in script:
        tclock.advance(0.01)
        rclock.advance(0.01)
        assert got.add(tick, kind, detail, stream=stream, shard=shard, value=value).to_dict() == \
            want.add(tick, kind, detail, stream=stream, shard=shard, value=value).to_dict()
        tags = {"tick": tick, "axis": "runtime", **({"stream": stream} if stream else {}),
                **({"shard": shard} if shard >= 0 else {})}
        robs.tracer.instant(kind, **tags)
    assert got.to_dict() == want.to_dict() and got.counts() == want.counts()
    assert got.reseat_ticks() == want.reseat_ticks() == 1
    assert got.recovery_times() == want.recovery_times() == [2.0]
    assert [s.to_dict() for s in tobs.tracer.spans()] == \
        [s.to_dict() for s in robs.tracer.spans()]
    assert {s.axis for s in tobs.tracer.spans()} == {"runtime"}
    with pytest.raises(TypeError, match="detail"):
        rchaos.ChaosLedger(obs=RObservatory()).add(0, "fault_inject", "kill shard 0")


def test_traced_storm_puts_the_ledger_on_the_timeline(pool):
    obs = Observatory()
    report, _, _ = run_chaos_episode("sensor_stall_storm", scheduler=pool["port"], obs=obs)
    instants = [s for s in obs.tracer.spans() if s.axis == "runtime"]
    assert [(s.name, s.tick, s.stream) for s in instants] == \
        [(e["kind"], e["tick"], e.get("stream", "")) for e in report.chaos["events"]]
    assert obs.tracer.dropped == 0


# ------------------------------------------------------------- replays -----
@pytest.fixture(scope="module")
def storms(pool):
    """sensor_stall_storm twice through the port's shared scheduler and
    once through the reference's."""
    port = [run_chaos_episode("sensor_stall_storm", scheduler=pool["port"]) for _ in range(2)]
    ref = rchaos.run_chaos_episode("sensor_stall_storm", scheduler=pool["ref"])
    return port, ref


def test_storm_matches_the_live_reference(storms):
    (got, got_rep, got_plan), _ = storms[0]
    want, want_rep, want_plan = storms[1]
    assert got_plan.to_json() == want_plan.to_json()
    _assert_same_ledger(got_rep.injector.ledger.events, want_rep.injector.ledger.events)
    _assert_same_report(got.to_dict(), want.to_dict())
    assert got.clock_s == want.clock_s         # the backoffs advanced both clocks alike
    assert got.to_dict()["chaos"]["counts"] == want.to_dict()["chaos"]["counts"]


def test_storm_meets_the_reference_s_gates(storms):
    report, replayer, plan = storms[0][0]
    counts = report.chaos["counts"]
    assert counts["fault_inject"] >= 10
    assert counts.get("nan_drop", 0) >= 1
    assert counts.get("watchdog", 0) >= 1
    assert counts.get("retry", 0) >= 1
    recovery = report.chaos["recovery_ticks"]
    assert recovery and max(recovery) <= 20
    # no stall, dropped frame or aborted bucket built a step anew
    assert [e.executor.step_captures for e in replayer.scheduler.engines.values()] == [1, 1, 1]
    json.loads(report.to_json(), parse_constant=lambda s: pytest.fail(f"bare {s}"))


def test_two_same_seed_storms_are_byte_identical(storms):
    (a, _, plan_a), (b, _, plan_b) = storms[0]
    assert plan_a.to_json() == plan_b.to_json()
    assert a.to_json() == b.to_json() and a.to_json(indent=2) == b.to_json(indent=2)
    assert a.chaos is not None


def _golden_trace(name):
    return compile_trace(get_episode(name), seed=GOLDEN_EPISODES[name],
                         tick_scale=GOLDEN_TICK_SCALE)


def _ref_golden_trace(name):
    return rtrace.compile_trace(rcatalog.get_episode(name), seed=GOLDEN_EPISODES[name],
                                tick_scale=GOLDEN_TICK_SCALE)


@pytest.mark.parametrize("name", sorted(GOLDEN_EPISODES))
def test_empty_plan_replay_is_byte_equal_to_no_plan(pool, storms, name):
    """Attached with an empty plan, the chaos machinery is pure observation
    — also on a scheduler that just replayed a storm (its resilience was
    dropped by reset) — and both replays match the live reference's."""
    trace = _golden_trace(name)
    empty = ScenarioReplayer(trace, scheduler=pool["port"], chaos=FaultPlan.empty()).run()
    plain = ScenarioReplayer(trace, scheduler=pool["port"]).run()
    assert empty.chaos is None and "chaos" not in empty.to_dict()
    assert empty.to_json(indent=2) == plain.to_json(indent=2)
    want = rreplay.ScenarioReplayer(_ref_golden_trace(name), scheduler=pool["ref"],
                                    chaos=rchaos.FaultPlan.empty()).run()
    _assert_same_report(empty.to_dict(), want.to_dict())


def test_reset_detaches_resilience(pool):
    sched = pool["port"]
    sched.attach_resilience(FleetResilience())
    sched._pending_reseat.add("cam_front")
    sched.reset()
    assert sched.resilience is None and not sched._pending_reseat
    assert sched.placer.cost is sched.cost and not sched.placer.dead


# ------------------------------------------------------- one-shard loss ----
_LOSS = dict(name="loss0", description="shard 0 lost for four ticks",
             clauses=(dict(kind="shard_loss", at=3, duration=4, shard=0),
                      dict(kind="step_fault", at=9, duration=1, count=5)))


def test_shard_loss_replay_matches_the_live_reference(pool):
    """A one-shard kill through the replayer: every seated stream unseated
    and force-degraded, then re-seated by the join of the tick the kill
    lands before (a ``failover`` with shard -1), the revive, and an aborted
    bucket (5 armed faults against 3 retries) — the reference's report and
    ledger."""
    trace = _golden_trace("urban_rush_hour")
    got = ScenarioReplayer(trace, scheduler=pool["port"], chaos=compile_plan(
        _specs(chaos, _LOSS), trace.streams, trace.n_ticks, seed=0))
    got_report = got.run()
    rtr = _ref_golden_trace("urban_rush_hour")
    want = rreplay.ScenarioReplayer(rtr, scheduler=pool["ref"], chaos=rchaos.compile_plan(
        _specs(rchaos, _LOSS), rtr.streams, rtr.n_ticks, seed=0))
    want_report = want.run()
    _assert_same_ledger(got.injector.ledger.events, want.injector.ledger.events)
    _assert_same_report(got_report.to_dict(), want_report.to_dict())
    counts = got_report.chaos["counts"]
    assert counts["failover"] == counts["degrade"] >= 1 and counts["abort"] == 1
    # the kill lands before its tick's scheduling: that tick's join re-seats
    assert got.injector.ledger.reseat_ticks() == 0


def _kill_script(sched, clock, cost, res, scenes_seq, scene_config):
    """Warm, seat STREAMS, tick twice, kill shard 0, tick, revive, tick;
    a snapshot of the scheduler's state after each step."""
    sched.reset()
    sched.set_virtual(clock, cost)
    sched.warm(scene_config(scenario="city", seed=5))
    for sid in STREAMS:
        sched.add_stream(sid, 0.03)
    sched.attach_resilience(res)

    def snap():
        return ({n: sorted(e.active) for n, e in sched.engines.items()},
                sorted(sched._pending_reseat), sorted(sched.placer.dead),
                {sid: (st.controller._idx, st.controller.switches, st.drops, st.frames)
                 for sid, st in sched.streams.items()},
                _ledger_rows(res.ledger.events))

    states = []
    for t in range(2):
        sched.tick(scenes_seq[t])
    states.append(snap())
    sched.kill_shard(0)
    states.append(snap())
    sched.tick(scenes_seq[2])
    states.append(snap())
    sched.revive_shard(0)
    sched.tick(scenes_seq[3])
    states.append(snap())
    with pytest.raises(ValueError, match="out of range"):
        sched.kill_shard(1)
    return states


def test_kill_shard_at_one_shard_follows_the_reference(pool):
    pairs = [{sid: _scene_pair(t, 40 + i) for i, sid in enumerate(STREAMS)} for t in range(4)]
    got = _kill_script(pool["port"], SimClock(), ModeledStageCost(replay_ladder(), seed=3),
                       FleetResilience(), [{s: p[0] for s, p in d.items()} for d in pairs],
                       SceneConfig)
    want = _kill_script(pool["ref"], RSimClock(), rreplay.ModeledStageCost(
        rreplay.replay_ladder(), seed=3), rchaos.FleetResilience(),
        [{s: p[1] for s, p in d.items()} for d in pairs], rdata.SceneConfig)
    assert got == want
    seated, pending, dead, ctl, ledger = got[1]
    assert not any(seated.values()) and pending == sorted(STREAMS) and dead == [0]
    assert [k for _, k, *_ in ledger] == ["degrade"] * 3
    seated, pending, dead, ctl, ledger = got[2]
    assert sorted(s for v in seated.values() for s in v) == sorted(STREAMS) and not pending
    assert [k for _, k, *_ in ledger[3:]] == ["failover"] * 3
    assert got[3][2] == []                      # revived


# ------------------------------------------- shard loss at two shards -----
# The reference cannot run two shards under this JAX (its sharded jit of the
# perception step raises ShardingTypeError on two forced host devices,
# ROADMAP.md Queue 3).  Its oracle is its own host logic at two shards over
# its one-device program: data_shards patched to 2 in its executor and
# scheduler, mesh None (tests/test_torch_fleet.py's docstring says why that
# is sound).  The port runs two CPU shards.

class _Captures:
    """A replay sentinel: each engine's captures as the tick loop starts
    (after the warm-up) and as it ends."""

    def __init__(self, sched):
        self.sched, self.at = sched, []

    def _read(self):
        self.at.append([e.executor.step_captures for e in self.sched.engines.values()])

    def __enter__(self):
        self._read()
        return self

    def __exit__(self, *exc):
        self._read()
        return False


def _tick_log(sched):
    """Record every tick's (buckets, shard_buckets) of a scheduler."""
    log, tick = [], sched.tick

    def logged(*args, **kw):
        res = tick(*args, **kw)
        log.append((res.buckets, res.shard_buckets))
        return res

    sched.tick = logged
    return log


@pytest.fixture(scope="module")
def shard_loss(ref_params):
    """shard_loss_rush_hour twice through one port scheduler at two CPU
    shards, and once through the reference's two-shard oracle."""
    port = RungBucketScheduler(replay_ladder(), capacity=CHAOS_CATALOG[
        "shard_loss_rush_hour"].capacity, device="cpu", params=ref_params,
        mesh=make_local_mesh(data=2, devices=["cpu", "cpu"]))
    port_log = _tick_log(port)
    runs = []
    for _ in range(2):
        guard = _Captures(port)
        runs.append(run_chaos_episode("shard_loss_rush_hour", scheduler=port, sentinel=guard)
                    + (guard.at,))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rexecutor, "data_shards", lambda mesh: 2)
        mp.setattr(rscheduler, "data_shards", lambda mesh: 2)
        ref_sched = RScheduler(rreplay.replay_ladder(), capacity=port.capacity)
        ref_log = _tick_log(ref_sched)
        ref = rchaos.run_chaos_episode("shard_loss_rush_hour", scheduler=ref_sched)
    return runs, port_log, ref, ref_log


def test_shard_loss_at_two_shards_matches_the_reference_oracle(shard_loss):
    runs, port_log, (want, want_rep, want_plan), _ = shard_loss
    got, got_rep, got_plan, _ = runs[0]
    assert got_plan.to_json() == want_plan.to_json()
    gl, wl = got_rep.injector.ledger, want_rep.injector.ledger
    _assert_same_ledger(gl.events, wl.events)
    assert gl.counts() == wl.counts() == {"failover": 2, "fault_inject": 2}
    assert gl.reseat_ticks() == wl.reseat_ticks() == 0
    assert got.totals() == want.totals() and got.totals()["frames"] == 112
    _assert_same_report(got.to_dict(), want.to_dict())
    assert got_rep.scheduler.n_shards == want_rep.scheduler.n_shards == 2
    assert {n: e.shard_occupancy() for n, e in got_rep.scheduler.engines.items()} == \
        {n: e.shard_occupancy() for n, e in want_rep.scheduler.engines.items()} == \
        {"two_stage": [0, 0], "one_stage": [2, 2], "early_exit@0.5": [0, 0]}
    assert [e.trace_count for e in want_rep.scheduler.engines.values()] == [1, 1, 1]


def test_shard_loss_buckets_per_tick_match_the_oracle(shard_loss):
    """Per tick, each rung's members and their split over the two shards:
    the kill at tick 8 moves shard 1's streams to shard 0 in that tick; the
    revive at 20 lets the rebalance move them back, one a tick."""
    runs, port_log, _, ref_log = shard_loss
    n = runs[0][0].n_ticks
    assert port_log[:n] == port_log[n:] == ref_log and len(ref_log) == n
    one = [sb.get("one_stage", {}) for _, sb in ref_log]
    assert all(set(sb) == {0} for sb in one[8:20]) and set(one[-1]) == {0, 1}


def test_shard_loss_captures_once_per_shard_and_replays_byte_identically(shard_loss):
    runs = shard_loss[0]
    for _, _, _, at in runs:
        # two captures per engine (one per shard) by the warm-up, none after
        assert at == [[2, 2, 2], [2, 2, 2]]
    a, b = runs[0][0], runs[1][0]
    assert a.to_json(indent=2) == b.to_json(indent=2)


def test_cli_runs_shard_loss_at_two_cpu_shards(tmp_path, capsys):
    out = tmp_path / "chaos.json"
    assert chaos_main(["--episode", "shard_loss_rush_hour", "--mesh", "data=2",
                       "--mesh-devices", "cpu,cpu", "--device", "cpu", "--check",
                       "--json-out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "[chaos] all gates passed" in text and "2 shard(s)" in text
    doc = json.loads(out.read_text())
    assert doc["gates"] == {"checked": True, "problems": []}
    assert doc["n_shards"] == 2 and doc["mesh"] == "data=2"
    assert doc["mesh_devices"] == ["cpu", "cpu"]
    assert set(doc["trace_counts"].values()) == {2}
    assert doc["sentinel"]["compiles"] == 0 and doc["sentinel"]["ok"]
    assert doc["ledger_counts"]["failover"] >= 1 and doc["reseat_ticks"] <= 3
    assert doc["report"]["chaos"]["counts"]["failover"] >= 1


# ------------------------------------------------------------------ CLIs ---
def test_cli_check_passes_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "chaos.json"
    assert chaos_main(["--episode", "sensor_stall_storm", "--check", "--device", "cpu",
                       "--json-out", str(out)]) == 0
    assert "[chaos] all gates passed" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    assert doc["gates"] == {"checked": True, "problems": []}
    assert doc["n_shards"] == 1 and set(doc["trace_counts"].values()) == {1}
    # --check replays under TraceSentinel(compile_budget=0), as the reference's
    assert doc["sentinel"] == {"compiles": 0, "traces": 0, "compile_budget": 0,
                               "trace_budget": None, "transfer_guard": "disallow", "ok": True}
    assert doc["ledger_counts"]["fault_inject"] >= 10 and doc["recovery_ticks"]
    assert doc["report"]["chaos"]["counts"] == doc["ledger_counts"]


@pytest.mark.parametrize("argv,msg", [
    (["--episode", "shard_loss_rush_hour", "--mesh", "data=2"], "name more devices"),
    (["--episode", "shard_loss_rush_hour"], "pass --mesh data=2"),
    (["--episode", "sensor_stall_storm", "--mesh-devices", "cpu,cpu"], "needs --mesh"),
    (["--episode", "sensor_stall_storm", "--mesh", "data=1,model=2"], "cannot be honored")],
    ids=["mesh", "two-shard-episode", "devices-without-mesh", "model-overflow"])
def test_cli_refuses_more_than_one_shard(argv, msg, capsys):
    """More shards than the mesh gives exit before anything runs: a
    two-shard episode without --mesh (as the reference's CLI) or on a mesh
    over the one CPU device (``--mesh-devices`` names more)."""
    with pytest.raises(SystemExit) as exc:
        chaos_main(argv + ["--device", "cpu"])
    assert exc.value.code == 2 and msg in capsys.readouterr().err


def test_run_chaos_episode_refuses_more_than_one_shard(pool):
    """On a one-shard scheduler the two-shard episode's kill of shard 1
    raises, as the reference's does; a reused scheduler keeps its mesh."""
    with pytest.raises(ValueError, match=r"shard 1 out of range \[0, 1\)"):
        run_chaos_episode("shard_loss_rush_hour", scheduler=pool["port"])
    with pytest.raises(ValueError, match=r"shard 1 out of range \[0, 1\)"):
        rchaos.run_chaos_episode("shard_loss_rush_hour", scheduler=pool["ref"])
    report, replayer, _ = run_chaos_episode(
        "sensor_stall_storm", scheduler=pool["port"],
        mesh=make_local_mesh(data=2, devices=["cpu", "cpu"]))
    assert replayer.scheduler is pool["port"] and replayer.scheduler.n_shards == 1


def test_entry_points_without_a_card_raise(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        chaos_main(["--episode", "sensor_stall_storm"])
    with pytest.raises(SystemExit, match="--device cpu"):
        serve.main(["--fleet", "--streams", "3", "--chaos", "sensor_stall_storm"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_chaos_episode("sensor_stall_storm")


def test_serve_fleet_with_chaos_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve
    path = tmp_path / "fleet.json"
    serve.main(["--fleet", "--streams", "3", "--ticks", "20", "--device", "cpu",
                "--chaos", "sensor_stall_storm", "--json-out", str(path)])
    out = capsys.readouterr().out
    doc = json.loads(path.read_text())
    want = rchaos.compile_plan(rchaos.get_chaos_episode("sensor_stall_storm").spec,
                               ["cam00", "cam01", "cam02"], 20, seed=0)
    assert f"({len(want.events)} fault event(s) over 20 ticks)" in out
    assert "chaos ledger: " in out and doc["chaos"]["events"]
    # the storm's stalls and NaN frames target the reference's camera names,
    # which a fleet of cam00.. does not have (as in the reference's serve):
    # only the latency spike and the step faults fire
    assert doc["chaos"]["counts"]["fault_inject"] == len(want.latency) + len(want.step_faults)
    assert all(n <= 1 for n in doc["trace_counts"].values())
    # a plan file serves the same way
    plan_path = tmp_path / "plan.json"
    FaultPlan.from_json(want.to_json()).save(plan_path)
    serve.main(["--fleet", "--streams", "3", "--ticks", "20", "--device", "cpu",
                "--chaos", str(plan_path), "--json-out", str(path)])
    assert json.loads(path.read_text())["chaos"] == doc["chaos"]
    with pytest.raises(SystemExit, match="wants 2 data shards, the fleet has 1: pass --mesh"):
        serve.main(["--fleet", "--streams", "3", "--device", "cpu",
                    "--chaos", "shard_loss_rush_hour"])
    with pytest.raises(SystemExit, match="neither"):
        serve.main(["--fleet", "--streams", "3", "--device", "cpu", "--chaos", "nope"])
