"""The port's scenario replay (``repro_torch.scenarios``) and its obs CLI
against the JAX reference, on the CPU.

Traces are pure Python and NumPy, so every catalog episode must compile to
the reference's JSON byte for byte.  Replays run the reference's seed-7
detector weights through ``params=`` (the port's own default weights come
from a torch generator and differ); a port replay and a live reference
replay then agree on every count, rung histogram and modeled latency
exactly, and on ``mean_quality`` within 5e-4 (the bound a 1e-3 px box
difference puts on an IoU of boxes 8 px or larger, as in
``test_torch_pipelined.py``; measured: 2.0e-8).  Against the checked-in
``tests/golden/*.json`` fixtures the replay must pass ``compare_reports``
with no violation.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.batched.scheduler import RungBucketScheduler as RScheduler  # noqa: E402
from repro.obs import Observatory as RObservatory  # noqa: E402
from repro.obs.__main__ import contention_attribution as r_contention  # noqa: E402
from repro.perception import detector as rdet  # noqa: E402
from repro.scenarios import catalog as rcatalog  # noqa: E402
from repro.scenarios import golden as rgolden  # noqa: E402
from repro.scenarios import replay as rreplay  # noqa: E402
from repro.scenarios import trace as rtrace  # noqa: E402

from repro_torch.anytime.runner import run_anytime, trace_budget_fn, \
    trace_scene_fn  # noqa: E402
from repro_torch.batched import RungBucketScheduler  # noqa: E402
from repro_torch.obs import Observatory  # noqa: E402
from repro_torch.obs.__main__ import MEDIATED_ORDER, contention_attribution  # noqa: E402
from repro_torch.obs.__main__ import main as obs_main  # noqa: E402
from repro_torch.perception import SceneConfig  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    CATALOG,
    ModeledStageCost,
    ScenarioReplayer,
    Tolerance,
    compare_reports,
    compile_trace,
    episode_names,
    get_episode,
    golden_replay,
    replay_ladder,
)
from repro_torch.scenarios import golden as tgolden  # noqa: E402
from repro_torch.scenarios.golden import GOLDEN_CAPACITY, GOLDEN_EPISODES, \
    GOLDEN_TICK_SCALE, golden_path  # noqa: E402
from repro_torch.scenarios.trace import ScenarioTrace, draw_scenario, stream_seed  # noqa: E402

GOLDEN_DIR = Path(__file__).parent / "golden"
QUALITY_TOL = 5e-4
GOLDEN = sorted(GOLDEN_EPISODES)


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
    the scheduler it is given)."""
    return {"port": RungBucketScheduler(replay_ladder(), capacity=GOLDEN_CAPACITY, device="cpu",
                                        params=ref_params),
            "ref": RScheduler(rreplay.replay_ladder(), capacity=GOLDEN_CAPACITY)}


def _replay(trace, pool, **kw):
    """A port replay through the module's shared scheduler."""
    return ScenarioReplayer(trace, scheduler=pool["port"], capacity=GOLDEN_CAPACITY, **kw).run()


def _ref_replay(trace, pool):
    return rreplay.ScenarioReplayer(trace, scheduler=pool["ref"],
                                    capacity=GOLDEN_CAPACITY).run()


def _golden_trace(name):
    return compile_trace(get_episode(name), seed=GOLDEN_EPISODES[name],
                         tick_scale=GOLDEN_TICK_SCALE)


@pytest.fixture(scope="module")
def golden_reports(pool):
    """Both golden episodes replayed by the port and by the reference,
    through one shared scheduler each."""
    out = {}
    for name in GOLDEN:
        port = _replay(_golden_trace(name), pool)
        ref = _ref_replay(rtrace.compile_trace(rcatalog.get_episode(name),
                                               seed=GOLDEN_EPISODES[name],
                                               tick_scale=GOLDEN_TICK_SCALE), pool)
        out[name] = (port, ref)
    return out


def _leaves(d, path=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(d, list):
        for i, v in enumerate(d):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, d


# ------------------------------------------------------------ trace format --
@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("name", sorted(rcatalog.CATALOG))
def test_catalog_compiles_to_the_reference_json(name, seed):
    for scale in (1.0, GOLDEN_TICK_SCALE):
        got = compile_trace(get_episode(name), seed=seed, tick_scale=scale)
        want = rtrace.compile_trace(rcatalog.get_episode(name), seed=seed, tick_scale=scale)
        assert got.to_json() == want.to_json()
        assert got.to_json(indent=2) == want.to_json(indent=2)
        assert ScenarioTrace.from_json(got.to_json()).to_json() == got.to_json()
        assert got.max_concurrent_streams() == want.max_concurrent_streams()


def test_catalog_and_ladder_constants_are_the_reference_s():
    assert episode_names() == rcatalog.episode_names()
    assert set(CATALOG) == set(rcatalog.CATALOG)
    assert len(replay_ladder()) == len(rreplay.replay_ladder())
    for a, b in zip(replay_ladder(), rreplay.replay_ladder()):
        assert (a.name, a.pipeline, a.scale, a.quality, a.stage_means) == \
            (b.name, b.pipeline, b.scale, b.quality, b.stage_means)
    assert (GOLDEN_EPISODES, GOLDEN_TICK_SCALE, GOLDEN_CAPACITY) == \
        (rgolden.GOLDEN_EPISODES, rgolden.GOLDEN_TICK_SCALE, rgolden.GOLDEN_CAPACITY)
    assert Tolerance() == Tolerance(**vars(rgolden.Tolerance()))


def test_stream_seed_and_draw_scenario_match_the_reference():
    for seg_seed in (0, 17, 2**31 - 5, 123456789):
        for sid in ("cam_front", "cam_left", "", "cam09"):
            assert stream_seed(seg_seed, sid) == rtrace.stream_seed(seg_seed, sid)
    mixes = [{"city": 1.0}, {"road": 0.2, "city": 0.5, "residential": 0.3},
             {"residential": 3.0, "city": 1.0}]
    for mix in mixes:
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        assert [draw_scenario(a, mix) for _ in range(200)] == \
            [rtrace.draw_scenario(b, mix) for _ in range(200)]


def test_stream_configs_match_the_reference():
    t = compile_trace(get_episode("rain_onset_clear"), seed=4, tick_scale=0.5)
    r = rtrace.compile_trace(rcatalog.get_episode("rain_onset_clear"), seed=4, tick_scale=0.5)
    got = [(c.scenario, c.rain_mm_per_hour, c.seed, i) for c, i in t.stream_configs("cam_left")]
    want = [(c.scenario, c.rain_mm_per_hour, c.seed, i) for c, i in r.stream_configs("cam_left")]
    assert got == want and len(got) == t.n_ticks


def test_modeled_stage_cost_draws_the_reference_s_sequence():
    got = ModeledStageCost(replay_ladder(), seed=11)
    want = rreplay.ModeledStageCost(rreplay.replay_ladder(), seed=11)
    calls = [("two_stage", "inference", 4, 0.0), ("one_stage", "post_processing", 3, 40.0),
             ("early_exit@0.5", "read", 1, 0.0), ("two_stage", "post_processing", 0, 0.0),
             ("one_stage", "pre_processing", 2, 0.0)]
    for contention in (1.0, 2.5):
        got.contention = want.contention = contention
        for c in calls * 3:
            assert got(*c) == want(*c)


# ------------------------------------------------------------------ replay --
@pytest.mark.parametrize("name", GOLDEN)
def test_golden_replay_matches_the_live_reference(golden_reports, name):
    """Every leaf of the two reports is equal, except mean_quality (within
    QUALITY_TOL); the two tolerance-banded comparisons are clean."""
    port, ref = golden_reports[name]
    got, want = port.to_dict(), ref.to_dict()
    assert compare_reports(got, want) == []
    a, b = dict(_leaves(got)), dict(_leaves(want))
    assert set(a) == set(b)
    n_quality = 0
    for path in sorted(b):
        if path.endswith(".mean_quality") and b[path] is not None:
            assert a[path] == pytest.approx(b[path], abs=QUALITY_TOL), path
            n_quality += 1
        else:
            assert a[path] == b[path], path
    assert n_quality > 0
    assert port.clock_s == ref.clock_s


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_replay_is_within_the_checked_in_fixture(golden_reports, name):
    port, _ = golden_reports[name]
    want = json.loads(golden_path(GOLDEN_DIR, name).read_text())
    problems = compare_reports(port.to_dict(), want)
    assert problems == [], "\n".join(problems)


def test_golden_replay_reuses_one_scheduler_without_a_new_build(golden_reports, pool):
    assert pool["port"].capacity == GOLDEN_CAPACITY
    for eng in pool["port"].engines.values():
        assert eng.trace_count <= 1


def test_replay_is_byte_deterministic(pool, ref_params):
    """Two replays through one reused scheduler and one through a scheduler
    built for it give the same bytes."""
    trace = _golden_trace("urban_rush_hour")
    a = _replay(trace, pool)
    b = _replay(trace, pool)
    c, _ = golden_replay("urban_rush_hour", params=ref_params, device="cpu")
    assert a.to_json() == b.to_json() == c.to_json()
    assert a.clock_s >= trace.duration_s - 1e-9


def test_tracing_on_and_off_give_byte_identical_reports(pool):
    obs = Observatory()
    on, sched = golden_replay("urban_rush_hour", scheduler=pool["port"], obs=obs)
    off, _ = golden_replay("urban_rush_hour", scheduler=sched)
    assert on.to_json() == off.to_json()
    assert obs.tracer.n_recorded > 0 and obs.tracer.dropped == 0
    assert len(obs.frames) == on.totals()["frames"]


def test_contention_attribution_matches_the_fixture(pool):
    """As tests/test_obs.py holds the reference: the hardware axis claims
    at least 80 % of the injected variance, and every axis share is within
    0.10 of the checked-in attribution fixture."""
    obs = Observatory()
    golden_replay("urban_rush_hour", scheduler=pool["port"], obs=obs)
    att = contention_attribution(obs)
    assert att.n > 0 and att.order == MEDIATED_ORDER
    injected = att.total_variance - att.explained["model"]["variance"]
    assert att.explained["hardware"]["variance"] / injected >= 0.80
    want = json.loads((GOLDEN_DIR / "urban_rush_hour.attribution.json").read_text())
    assert list(att.order) == want["order"]
    assert att.n == pytest.approx(want["n"], rel=0.25)
    for axis, share in want["shares"].items():
        assert att.explained[axis]["share"] == pytest.approx(share, abs=0.10), axis


def test_traced_replay_matches_the_reference_s_trace(pool, ref_params):
    """The same spans, instants and attribution samples as the reference's
    traced replay of the same episode."""
    tobs, robs = Observatory(), RObservatory()
    golden_replay("urban_rush_hour", scheduler=pool["port"], obs=tobs)
    rgolden.golden_replay("urban_rush_hour", scheduler=pool["ref"], obs=robs)
    assert tobs.tracer.n_recorded == robs.tracer.n_recorded
    assert [s.to_dict() for s in tobs.tracer.spans()] == \
        [s.to_dict() for s in robs.tracer.spans()]
    assert len(tobs.frames) == len(robs.frames)
    for a, b in zip(tobs.frames, robs.frames):
        assert (a.latency_s, a.stream, a.tick, a.segment, a.rung, a.batch_size, a.work,
                a.contention) == (b.latency_s, b.stream, b.tick, b.segment, b.rung,
                                  b.batch_size, b.work, b.contention)
    ratt, tatt = r_contention(robs), contention_attribution(tobs)
    for axis in MEDIATED_ORDER:
        assert tatt.explained[axis]["share"] == pytest.approx(
            ratt.explained[axis]["share"], abs=1e-9)


def test_obs_cli_passes_on_the_cpu(tmp_path):
    out = tmp_path / "obs_trace.json"
    assert obs_main(["--episode", "urban_rush_hour", "--device", "cpu",
                     "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["traceEvents"]


def test_scenarios_cli_checks_the_goldens_with_the_port_s_weights(tmp_path, capsys):
    """The port's own seed-7 weights differ from the reference's, yet both
    golden episodes stay within the fixtures' bands."""
    assert tgolden.main(["--check", "--device", "cpu", "--out", str(tmp_path)]) == 0
    assert "all episodes within tolerance" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        sorted(f"{n}.report.json" for n in GOLDEN_EPISODES)


def test_scenarios_cli_regen_needs_its_own_dir(tmp_path):
    with pytest.raises(SystemExit):
        tgolden.main(["--regen", "--device", "cpu"])
    assert tgolden.main(["--regen", "--device", "cpu", "--dir", str(tmp_path)]) == 0
    assert tgolden.main(["--check", "--device", "cpu", "--dir", str(tmp_path)]) == 0


# ------------------------------------------------- catalog behaviours ------
def test_tunnel_entry_drops_frames_and_starves_fusion(pool):
    trace = compile_trace(get_episode("tunnel_entry"), seed=7, tick_scale=0.5)
    report = _replay(trace, pool)
    tunnel = next(s for s in report.segments if s.label == "tunnel")
    clear = next(s for s in report.segments if s.label == "approach")
    assert tunnel.drops > 0 and clear.drops == 0
    assert tunnel.fusion["dropped"] + tunnel.fusion["stranded"] > 0
    assert sum(r["drops"] for r in pool["port"].report()) == \
        sum(s.drops for s in report.segments)


def test_camera_churn_changes_stream_sets(pool):
    trace = compile_trace(get_episode("camera_churn"), seed=7, tick_scale=0.5)
    report = _replay(trace, pool)
    two, four, three = report.segments
    assert set(two.streams) == {"cam_front", "cam_left"}
    assert set(four.streams) == {"cam_front", "cam_left", "cam_right", "cam_rear"}
    assert set(three.streams) == {"cam_front", "cam_right", "cam_rear"}
    assert all(st.frames > 0 for st in four.streams.values())


def test_contention_spike_degrades_fidelity(pool):
    trace = compile_trace(get_episode("contention_spike"), seed=7, tick_scale=0.5)
    report = _replay(trace, pool)
    ladder = [r.name for r in pool["port"].ladder]

    def worst_rung(seg):
        return max(ladder.index(r) for r in seg.rung_hist)

    nominal = report.segments[0]
    rest = [s for s in report.segments if s.label != "nominal"]
    assert max(worst_rung(s) for s in rest) > worst_rung(nominal)
    assert sum(s.misses for s in report.segments if s.label.startswith("spike")) > 0


@pytest.mark.parametrize("name", ["tunnel_entry", "camera_churn", "contention_spike",
                                  "latency_attack_ramp", "highway_cruise"])
def test_catalog_episode_replay_matches_the_reference(pool, name):
    trace = compile_trace(get_episode(name), seed=7, tick_scale=0.5)
    got = _replay(trace, pool).to_dict()
    want = _ref_replay(rtrace.compile_trace(rcatalog.get_episode(name), seed=7,
                                            tick_scale=0.5), pool).to_dict()
    assert compare_reports(got, want, Tolerance(quality=QUALITY_TOL, rel=0.0, abs_ms=0.0,
                                                rate=0.0, count_frac=0.0, count_abs=0)) == []


def test_run_anytime_accepts_trace_profiles():
    trace = compile_trace(get_episode("contention_spike"), seed=3, tick_scale=0.5)
    ladder = replay_ladder(["one_stage", "early_exit@0.5"])
    cfg = SceneConfig(scenario="city", seed=3)
    rep = run_anytime(ladder, cfg, budget_s=trace.budget_s, n=trace.n_ticks,
                      budget_fn=trace_budget_fn(trace),
                      scene_fn=trace_scene_fn(trace, "cam_front"), device="cpu")
    assert len(rep.frames) == trace.n_ticks
    budgets = [f.budget_s for f in rep.frames]
    assert min(budgets) < budgets[0]
    assert budgets[-1] == pytest.approx(trace.budget_at_tick(trace.n_ticks - 1))


# --------------------------------------------------------- API guards ------
def test_chaos_and_mesh_raise_until_ported():
    trace = _golden_trace("urban_rush_hour")
    with pytest.raises(NotImplementedError, match="step 7"):
        ScenarioReplayer(trace, chaos=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="step 8"):
        ScenarioReplayer(trace, mesh=object(), device="cpu")


def test_reused_scheduler_rejects_construction_arguments(pool, ref_params):
    trace = _golden_trace("urban_rush_hour")
    for kw in ({"params": ref_params}, {"device": "cpu"}, {"ladder": replay_ladder()},
               {"generator": torch.Generator().manual_seed(7)}, {"capacity": 9}):
        with pytest.raises(ValueError):
            ScenarioReplayer(trace, scheduler=pool["port"], **kw)
    with pytest.raises(ValueError, match="capacity"):
        ScenarioReplayer(trace, capacity=1, device="cpu")


def test_replay_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScenarioReplayer(_golden_trace("urban_rush_hour"))
    with pytest.raises(SystemExit, match="--device cpu"):
        tgolden.main(["--check"])
    with pytest.raises(SystemExit, match="--device cpu"):
        obs_main([])


def test_compare_reports_flags_drift_and_structure():
    tol = Tolerance()
    want = {"label": "a", "p50_ms": 10.0, "frames": 20,
            "miss_rate": 0.1, "streams": {"s": {"frames": 5}}}
    assert compare_reports(json.loads(json.dumps(want)), want, tol) == []
    got = json.loads(json.dumps(want))
    got["p50_ms"] = 10.0 * (1 + tol.rel) + tol.abs_ms + 1.0
    got["label"] = "b"
    got["streams"]["s"]["frames"] = 5 + tol.count_abs + 4
    problems = compare_reports(got, want, tol)
    assert problems == rgolden.compare_reports(got, want, rgolden.Tolerance())
    assert len(problems) == 3
