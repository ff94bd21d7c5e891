"""The anytime slice of the port (``repro_torch.anytime``, and the
``core.predictor`` and ``sched.simulator`` copies it stands on) against the
JAX reference on the CPU, on the same inputs.

The controller, cost model, predictors and simulator are host Python, so
the two packages must make the same decisions on the same records: equal
selections, switches and predictions (to 1e-12 where floats are compared).
``calibrate`` runs real frames: the rung order must be equal and the
qualities within 1e-6 (the boxes agree to 1e-4 px; a quality is a mean of
IoUs); its latencies are wall clock and are not compared.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import anytime as ra  # noqa: E402
from repro.core import predictor as rpred  # noqa: E402
from repro.core.timing import StageRecord as RRecord  # noqa: E402
from repro.perception import SceneConfig as RCfg, run_pipeline as r_run  # noqa: E402
from repro.perception import detector as rdet, lane as rlane  # noqa: E402
from repro.sched import simulator as rsim  # noqa: E402
from repro_torch import anytime as ta  # noqa: E402
from repro_torch.core import predictor as tpred  # noqa: E402
from repro_torch.core.timing import StageRecord as TRecord  # noqa: E402
from repro_torch.perception import SceneConfig as TCfg  # noqa: E402
from repro_torch.sched import simulator as tsim  # noqa: E402

EXACT = dict(rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def ref_params():
    key = jax.random.PRNGKey(7)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    one = np_tree(rdet.OneStageDetector().init(key))
    return {"one_stage": one, "early_exit": one,
            "two_stage": np_tree(rdet.TwoStageDetector().init(key)),
            "lane": np_tree(rlane.LaneDetector().init(key))}


def toy_ladders():
    """The reference test suite's toy ladder, built in both packages."""
    def rung(pkg, name, e2e, quality):
        return pkg.Rung(name, "one_stage", 1.0, quality=quality, stage_means={
            "read": 0.02 * e2e, "pre_processing": 0.18 * e2e,
            "inference": 0.50 * e2e, "post_processing": 0.30 * e2e})

    spec = [("hi", 8e-3, 0.70), ("mid", 4e-3, 0.55), ("lo", 1.5e-3, 0.30)]
    return (ra.Ladder([rung(ra, *s) for s in spec]), ta.Ladder([rung(ta, *s) for s in spec]))


def records(rung_stage_means, scale, proposals):
    stages = {k: v * scale for k, v in rung_stage_means.items()}
    meta = {"num_proposals": proposals}
    return RRecord(stages=dict(stages), meta=dict(meta)), TRecord(stages=stages, meta=meta)


def same_prediction(got, want):
    np.testing.assert_allclose([got.mean, got.std], [want.mean, want.std], **EXACT)


def same_selection(got, want):
    assert (got.rung.name, got.index, got.fits, got.reason) == \
        (want.rung.name, want.index, want.fits, want.reason)
    same_prediction(got.predicted, want.predicted)


# ------------------------------------------------------------- predictor --

SERIES = np.random.default_rng(3).gamma(4.0, 2e-3, 64)
FEATURES = np.random.default_rng(4).integers(5, 90, 64).astype(float)


@pytest.mark.parametrize("name", ["GaussianPredictor", "KalmanPredictor"])
def test_predictors_match_on_one_series(name):
    got, want = getattr(tpred, name)(), getattr(rpred, name)()
    same_prediction(got.predict(), want.predict())          # both NaN before data
    for x in SERIES:
        got.observe(x)
        want.observe(x)
        same_prediction(got.predict(), want.predict())
    for q in (0.5, 0.9, 0.95, 0.99):
        np.testing.assert_allclose(got.predict().quantile(q), want.predict().quantile(q), **EXACT)
    for d in (5e-3, 8e-3, 2e-2):
        assert got.predict().prob_exceeds(d) == want.predict().prob_exceeds(d)
    assert tpred.rolling_eval(getattr(tpred, name)(), SERIES) == \
        rpred.rolling_eval(getattr(rpred, name)(), SERIES)


def test_feature_predictor_matches():
    got, want = tpred.FeaturePredictor(), rpred.FeaturePredictor()
    for x, f in zip(SERIES, FEATURES):
        got.observe(x, f)
        want.observe(x, f)
        same_prediction(got.predict(f), want.predict(f))
    assert tpred.rolling_eval(tpred.FeaturePredictor(), SERIES, FEATURES) == \
        rpred.rolling_eval(rpred.FeaturePredictor(), SERIES, FEATURES)


# ------------------------------------------------------------- simulator --

def _tasks(pkg, policy):
    chains = [(pkg.StageSpec("pre", "cpu", 1e-3), pkg.StageSpec("infer", "accel", 4e-3),
               pkg.StageSpec("post", "cpu", 2e-3 * s)) for s in (1.0, 0.5, 0.2)]
    return [pkg.TaskSpec("cam", 0.01, chains[0], policy=policy, priority=2,
                         deadline_budget=3e-3, n_jobs=40, rungs=tuple(chains),
                         rung_fn=lambda j: j % 3),
            pkg.TaskSpec("lidar", 0.02, chains[1], policy=policy, priority=1,
                         deadline_budget=2e-3, n_jobs=20)]


@pytest.mark.parametrize("policy", ["OTHER", "FIFO", "RR", "DEADLINE"])
def test_simulator_matches(policy):
    got = tsim.simulate(_tasks(tsim, policy), tsim.SimConfig(cpu_cores=1, seed=5))
    want = rsim.simulate(_tasks(rsim, policy), rsim.SimConfig(cpu_cores=1, seed=5))
    for task in ("cam", "lidar"):
        assert np.array_equal(got.latencies[task], want.latencies[task])
        assert np.array_equal(got.rungs[task], want.rungs[task])
    assert got.throttle_events == want.throttle_events
    assert got.miss_rates == want.miss_rates


def test_rung_stage_specs_feed_the_simulator():
    rlad, tlad = toy_ladders()
    for rr, tr in zip(rlad, tlad):
        assert ta.rung_stage_specs(tr) == tuple(
            tsim.StageSpec(s.name, s.resource, s.mean, s.jitter)
            for s in ra.rung_stage_specs(rr))

    def task(pkg, lad, sim):
        chains = tuple(pkg.rung_stage_specs(r) for r in lad)
        return sim.TaskSpec("cam", 6e-3, chains[0], n_jobs=30, rungs=chains,
                            rung_fn=lambda j: (j // 10) % 3)

    got = tsim.simulate([task(ta, tlad, tsim)], tsim.SimConfig(seed=2))
    want = rsim.simulate([task(ra, rlad, rsim)], rsim.SimConfig(seed=2))
    assert np.array_equal(got.latencies["cam"], want.latencies["cam"])
    assert np.array_equal(got.rungs["cam"], want.rungs["cam"])
    with pytest.raises(ValueError, match="uncalibrated"):
        ta.rung_stage_specs(ta.Rung("raw", "one_stage"))


# ------------------------------------------------------------ cost model --

@pytest.mark.parametrize("feats", [
    dict(), dict(proposals_prev=40.0), dict(scenario="road", rain_mm_per_hour=80.0),
    dict(batch_size=4.0), dict(batch_size=1.0, batched=True, pipeline_depth=3.0),
])
def test_cost_models_match_after_the_same_records(feats):
    rlad, tlad = toy_ladders()
    rcm, tcm = ra.LadderCostModel(rlad), ta.LadderCostModel(tlad)
    rng = np.random.default_rng(9)
    for i in range(24):
        for rr, tr in zip(rlad, tlad):
            props = float(rng.integers(5, 80))
            rrec, trec = records(rr.stage_means, 1.0 + 0.3 * rng.random(), props)
            batched = dict(batch_size=2.0 + i % 3) if i % 4 == 3 else {}
            if batched:
                rrec.meta["frame_latency_s"] = trec.meta["frame_latency_s"] = 0.02 + 1e-3 * i
            rcm.observe(rr.name, rrec, ra.SceneFeatures(proposals_prev=props, **batched))
            tcm.observe(tr.name, trec, ta.SceneFeatures(proposals_prev=props, **batched))
            for r in rlad:
                same_prediction(tcm.predict(r.name, ta.SceneFeatures(**feats)),
                                rcm.predict(r.name, ra.SceneFeatures(**feats)))
    for r in rlad:
        for q in (0.5, 0.95, 0.99):
            np.testing.assert_allclose(tcm.quantile(r.name, ta.SceneFeatures(**feats), q),
                                       rcm.quantile(r.name, ra.SceneFeatures(**feats), q), **EXACT)
    assert ta.SceneFeatures(**feats).composite() == ra.SceneFeatures(**feats).composite()


def test_cold_start_prior_table_matches():
    rlad, tlad = toy_ladders()
    got = ta.cost.cold_start_prior_table(tlad, (1, 2, 4, 8), depth=2.0)
    want = ra.cost.cold_start_prior_table(rlad, (1, 2, 4, 8), depth=2.0)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], **EXACT)
    with pytest.raises(ValueError, match="uncalibrated"):
        ta.LadderCostModel(ta.Ladder([ta.Rung("raw", "one_stage")]))


# ------------------------------------------------------------ controller --

def _drive(ctl_r, ctl_t, rlad, budgets, scale_fn=lambda i: 1.0, degrade_at=()):
    """One budget and record trace through both controllers; every
    selection compared."""
    trace = []
    for i, budget in enumerate(budgets):
        if i in degrade_at:
            assert ctl_t.force_degrade(2) == ctl_r.force_degrade(2)
        want = ctl_r.select(budget, ra.SceneFeatures())
        got = ctl_t.select(budget, ta.SceneFeatures())
        same_selection(got, want)
        rrec, trec = records(want.rung.stage_means, scale_fn(i), 40.0)
        ctl_r.observe(want.rung.name, rrec, ra.SceneFeatures())
        ctl_t.observe(got.rung.name, trec, ta.SceneFeatures())
        trace.append(got.rung.name)
    assert ctl_t.switches == ctl_r.switches
    return trace


def test_contract_controller_degrades_and_recovers_alike():
    rlad, tlad = toy_ladders()
    budgets = [1.8e-3 if 8 <= i < 16 else 40e-3 for i in range(24)]
    trace = _drive(ra.ContractController(rlad, cfg=ra.ControllerConfig(hold_frames=3)),
                   ta.ContractController(tlad, cfg=ta.ControllerConfig(hold_frames=3)),
                   rlad, budgets)
    assert trace[:8] == ["hi"] * 8 and set(trace[8:16]) == {"lo"} and trace[-1] == "hi"


def test_contract_controller_hysteresis_alike():
    rlad, tlad = toy_ladders()
    cfg = dict(hold_frames=3, upgrade_headroom=1.25)
    ctl_r = ra.ContractController(rlad, cfg=ra.ControllerConfig(**cfg))
    ctl_t = ta.ContractController(tlad, cfg=ta.ControllerConfig(**cfg))
    tail = ctl_r.cost.predict("hi", ra.SceneFeatures()).quantile(0.95)
    budgets = [tail * (1.03 if i % 2 == 0 else 0.97) for i in range(30)]
    _drive(ctl_r, ctl_t, rlad, budgets, scale_fn=lambda i: 1.0 + 0.05 * (i % 3))
    assert ctl_t.switches <= 2


def test_force_degrade_and_floor_alike():
    rlad, tlad = toy_ladders()
    ctl_r, ctl_t = ra.ContractController(rlad), ta.ContractController(tlad)
    _drive(ctl_r, ctl_t, rlad, [40e-3] * 12 + [1e-9] * 3 + [40e-3] * 10, degrade_at=(4, 5, 20))
    with pytest.raises(ValueError, match="steps"):
        ctl_t.force_degrade(0)
    with pytest.raises(ValueError, match="quantile"):
        ta.ControllerConfig(quantile=1.0)
    with pytest.raises(ValueError, match="pipeline_depth"):
        ta.ControllerConfig(pipeline_depth=0.5)


@pytest.mark.parametrize("rung", [None, "mid", "lo"])
def test_fixed_controller_alike(rung):
    rlad, tlad = toy_ladders()
    _drive(ra.FixedController(rlad, rung), ta.FixedController(tlad, rung), rlad,
           [3e-3, 9e-3, 2e-3, 40e-3] * 4)


def test_pipelined_controller_alike():
    rlad, tlad = toy_ladders()
    ctl_r = ra.ContractController(rlad, cfg=ra.ControllerConfig(pipeline_depth=3.0))
    ctl_t = ta.ContractController(tlad, cfg=ta.ControllerConfig(pipeline_depth=3.0))
    for budget in (0.1, 0.03, 0.01):
        feats = dict(batch_size=4.0)
        same_selection(ctl_t.select(budget, ta.SceneFeatures(**feats)),
                       ctl_r.select(budget, ra.SceneFeatures(**feats)))


# ------------------------------------------------------- real pipelines --

@pytest.mark.parametrize("name", ["one_stage", "two_stage", "early_exit"])
def test_frame_quality_is_the_reference(ref_params, name):
    _, outs = r_run(name, RCfg("city", seed=2), n=6, collect=True)
    for scene, out in outs:
        want = ra.frame_quality(scene, out)
        got = ta.frame_quality(scene, out)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_allclose(got, want, **EXACT)


@pytest.mark.parametrize("scenario,seed", [("city", 3), ("residential", 7)])
def test_calibrate_orders_and_scores_rungs_alike(ref_params, scenario, seed):
    want = ra.calibrate(ra.default_rungs(), RCfg(scenario, seed=seed), n=6)
    got = ta.calibrate(ta.default_rungs(), TCfg(scenario, seed=seed), n=6, device="cpu",
                       params=ref_params)
    assert [r.name for r in got] == [r.name for r in want]
    np.testing.assert_allclose([r.quality for r in got], [r.quality for r in want],
                               atol=1e-6, rtol=0)
    for r in got:
        assert set(r.stage_means) == {"read", "pre_processing", "inference", "post_processing"}
        assert math.isfinite(r.e2e_mean) and r.e2e_mean > 0


def test_run_anytime_report_alike(ref_params):
    """A fixed rung runs the same frames through the same pipeline in both
    packages: per-frame quality and proposals agree; the report's structure
    matches; latencies are wall clock and only checked for sanity."""
    rlad = ra.calibrate(ra.default_rungs(), RCfg("city", seed=3), n=4)
    built = ta.build_rungs(ta.default_rungs(), TCfg("city", seed=3), device="cpu",
                           params=ref_params)
    tlad = ta.calibrate(ta.default_rungs(), TCfg("city", seed=3), n=4, built=built)
    for rung in (None, rlad.floor.name):
        want = ra.run_anytime(rlad, RCfg("city", seed=3), 1.0,
                              controller=ra.FixedController(rlad, rung), n=10)
        got = ta.run_anytime(tlad, TCfg("city", seed=3), 1.0,
                             controller=ta.FixedController(tlad, rung), n=10, built=built)
        assert len(got.frames) == len(want.frames) == 10
        assert got.rung_trace() == want.rung_trace() and got.switches == want.switches == 0
        for g, w in zip(got.frames, want.frames):
            assert (g.index, g.rung, g.budget_s, g.num_proposals, g.fits, g.miss) == \
                (w.index, w.rung, w.budget_s, w.num_proposals, w.fits, w.miss)
            assert (g.quality is None) == (w.quality is None)
            if w.quality is not None:
                assert abs(g.quality - w.quality) <= 1e-6
            assert 0 < g.latency_s < 1.0
        assert got.recorder.stages() == want.recorder.stages()
        np.testing.assert_allclose(got.mean_quality, want.mean_quality, atol=1e-6, rtol=0)
        assert got.miss_rate == want.miss_rate == 0.0
        assert np.array_equal(got.recorder.meta_series("rung_index"),
                              want.recorder.meta_series("rung_index"))
    rep = ta.run_anytime(tlad, TCfg("city", seed=3), 0.5 * tlad.top.e2e_mean, n=12,
                         built=built, budget_fn=lambda i: 1e-9 if 4 <= i < 8 else 1.0)
    trace = rep.rung_trace()
    assert set(trace[4:8]) == {tlad.floor.name} and trace[0] == tlad.top.name
    assert sum(rep.rung_counts().values()) == 12 and math.isfinite(rep.p99_latency)


@pytest.mark.parametrize("entry", ["build_rungs", "calibrate", "run_anytime"])
def test_anytime_entry_points_need_a_card_for_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TCfg("city", seed=3)
    rlad, tlad = toy_ladders()
    call = {"build_rungs": lambda: ta.build_rungs(ta.default_rungs(), cfg),
            "calibrate": lambda: ta.calibrate(ta.default_rungs(), cfg, n=1),
            "run_anytime": lambda: ta.run_anytime(tlad, cfg, 1.0, n=1)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
