"""The depth-k pipeline of the port's batched engine (``repro_torch.batched``)
on the CPU: bitwise identity of depth 2 and 3 with the synchronous path,
staleness and payload echo, slot churn mid-pipeline, dirty-slot upload
accounting, completion latency, the executor's guards, the scheduler's
depth wiring — and one scheduler parity test against the JAX reference:
both schedulers run the same scenes and budgets under a SimClock with the
same deterministic stage cost, so every decision must agree (buckets,
rungs, counts and modeled latencies exactly; boxes within 1e-3 px;
qualities within 5e-4, the bound a 1e-3 px box difference puts on an IoU
of boxes 8 px or larger).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.anytime import Ladder as RLadder, Rung as RRung  # noqa: E402
from repro.batched import RungBucketScheduler as RScheduler  # noqa: E402
from repro.bus.clock import SimClock as RClock  # noqa: E402
from repro.perception import detector as rdet  # noqa: E402
from repro_torch.anytime import Ladder, Rung, calibrate  # noqa: E402
from repro_torch.anytime.cost import SceneFeatures  # noqa: E402
from repro_torch.batched import BatchedPerceptionEngine, PipelinedExecutor, \
    RungBucketScheduler  # noqa: E402
from repro_torch.bus import SimClock  # noqa: E402
from repro_torch.core.timing import StageRecord  # noqa: E402
from repro_torch.perception import SceneConfig, generate_scene  # noqa: E402

CITY = SceneConfig("city", seed=33)
QUALITY_TOL = 5e-4


@pytest.fixture(scope="module")
def ref_params():
    key = jax.random.PRNGKey(7)
    tree = lambda det: jax.tree.map(np.asarray, det.init(key))
    one = tree(rdet.OneStageDetector())
    return {"one_stage": one, "early_exit": one, "two_stage": tree(rdet.TwoStageDetector())}


def _scenes(n_ticks, n_streams, seed0=200):
    return [[generate_scene(SceneConfig("city", seed=seed0 + s), t + 1) for s in range(n_streams)]
            for t in range(n_ticks)]


def _outputs_equal(a, b):
    assert a.num_objects == b.num_objects
    assert a.num_proposals == b.num_proposals
    assert a.boxes.shape == b.boxes.shape
    assert np.array_equal(a.boxes, b.boxes), "boxes differ bitwise"


def _engine(ref_params, name="early_exit", **kw):
    return BatchedPerceptionEngine(name, device="cpu", params=ref_params, **kw)


# ------------------------------------------ bitwise depth-k == depth-1 ----
@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("name", ["two_stage", "one_stage"])
def test_depth_k_outputs_bitwise_identical_to_depth_1(ref_params, name, depth):
    """The pipeline reorders *when* work happens, never *what* is
    computed: every frame's outputs are bitwise those of the synchronous
    engine, in submission order."""
    n_streams, n_ticks = 3, 5
    scenes = _scenes(n_ticks, n_streams)
    results = {}
    for d in (1, depth):
        eng = _engine(ref_params, name, capacity=n_streams, depth=d)
        for s in range(n_streams):
            eng.join(f"cam{s}")
        seq = {f"cam{s}": [] for s in range(n_streams)}
        for t in range(n_ticks):
            _, outs = eng.tick({f"cam{s}": scenes[t][s].image for s in range(n_streams)})
            for sid, out in outs.items():
                seq[sid].append(out)
        for _, outs, _ in eng.flush():
            for sid, out in outs.items():
                seq[sid].append(out)
        results[d] = seq
        assert eng.trace_count == 1 and eng.replay_count == n_ticks
    for sid in results[1]:
        assert len(results[depth][sid]) == n_ticks
        for a, b in zip(results[1][sid], results[depth][sid]):
            _outputs_equal(a, b)


def test_pipeline_fills_then_returns_stale_results(ref_params):
    eng = _engine(ref_params, capacity=2, depth=2)
    eng.join("a")
    img0, img1 = generate_scene(CITY, 1).image, generate_scene(CITY, 2).image
    rec, outs = eng.tick({"a": img0})
    assert rec is None and outs == {}          # filling: nothing to drain
    assert eng.in_flight == 1
    rec, outs = eng.tick({"a": img1})
    assert rec is not None and set(outs) == {"a"}
    assert rec.meta["staleness_ticks"] == 1.0  # these are tick-0 results
    assert rec.meta["frame_latency_s"] > 0.0
    assert set(rec.stages) == {"read", "upload", "inference", "post_processing"}
    tail = eng.flush()
    assert len(tail) == 1 and set(tail[0][1]) == {"a"}
    assert eng.in_flight == 0
    assert eng.ticks == 2 and len(eng.tick_log) == 2


def test_payload_echo_pairs_results_with_their_tick(ref_params):
    eng = _engine(ref_params, capacity=1, depth=2)
    eng.join("a")
    img = generate_scene(CITY, 1).image
    rec, outs, echoed = eng.tick({"a": img}, payload="tick0")
    assert rec is None and echoed is None
    rec, outs, echoed = eng.tick({"a": img}, payload="tick1")
    assert echoed == "tick0"                   # results are one tick stale
    (_, _, echoed2), = eng.flush()
    assert echoed2 == "tick1"


def test_join_leave_mid_pipeline_drains_cleanly(ref_params):
    """Slot churn while frames are in flight: results stay attributed to
    the submission-time streams, later occupants of a slot never inherit
    them, and nothing is built twice."""
    eng = _engine(ref_params, capacity=3, depth=2)
    img = generate_scene(CITY, 1).image
    eng.compile()
    eng.join("a")
    eng.join("b")
    eng.tick({"a": img, "b": img})             # in flight: {a, b}
    eng.join("c")                              # join mid-pipeline
    rec, outs = eng.tick({"a": img, "b": img, "c": img})
    assert set(outs) == {"a", "b"}             # drained tick predates c
    eng.leave("b")                             # leave with frame in flight
    tail = eng.flush()
    assert len(tail) == 1
    assert set(tail[0][1]) == {"a", "b", "c"}  # b's in-flight result drains
    assert "b" not in eng.active
    eng.join("d")                              # d takes b's blanked slot
    eng.tick({"a": img, "d": img})
    eng.flush()
    assert eng.trace_count == 1 and eng.replay_count == 3


def test_h2d_bytes_are_dirty_slots_only(ref_params):
    eng = _engine(ref_params, capacity=4, depth=1)
    frame_bytes = int(np.prod(eng.image_shape)) * 4
    for sid in ("a", "b", "c"):
        eng.join(sid)
    img = generate_scene(CITY, 1).image
    rec, _ = eng.tick({"a": img, "b": img})    # only 2 of 4 slots dirty
    assert rec.meta["h2d_bytes"] == 2 * frame_bytes
    rec, _ = eng.tick({"c": img})
    assert rec.meta["h2d_bytes"] == 1 * frame_bytes


def test_pipelined_reports_use_completion_latency_and_serving_span(ref_params):
    """frames/s comes from the observed serving span and percentiles from
    submit→drain latency, never from the overlapped host residual."""
    eng = _engine(ref_params, capacity=2, depth=2)
    eng.join("a")
    img = generate_scene(CITY, 1).image
    for _ in range(4):
        eng.tick({"a": img})
    eng.flush()
    agg = eng.aggregate_report()
    host_residual_fps = agg["frames"] / sum(lat for _, lat in eng.tick_log)
    assert agg["frames"] == 4
    assert agg["frames_per_s"] <= host_residual_fps
    assert np.isfinite(agg["frames_per_s"]) and agg["frames_per_s"] > 0
    frame_lats = eng.recorder.meta_series("frame_latency_s")
    assert (frame_lats >= eng.recorder.end_to_end_series() - 1e-9).all()
    rows = eng.per_stream_report()
    assert rows[0]["p99_s"] == pytest.approx(float(np.percentile(frame_lats, 99)))


def test_stage_cost_requires_sync_depth(ref_params):
    with pytest.raises(ValueError, match="depth-1"):
        _engine(ref_params, capacity=2, depth=2, stage_cost=lambda s, b, w: 0.0)


def test_flush_is_empty_on_sync_engine(ref_params):
    eng = _engine(ref_params, capacity=1)
    eng.join("a")
    eng.tick({"a": generate_scene(CITY, 1).image})
    assert eng.flush() == [] and eng.in_flight == 0


# ------------------------------------------------ executor unit level -----
def _sum_step(raw):
    return raw.sum(dim=(1, 2, 3))


def test_executor_validates_and_guards():
    with pytest.raises(ValueError, match="depth"):
        PipelinedExecutor(_sum_step, 2, (8, 8, 3), depth=0, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        PipelinedExecutor(_sum_step, 0, (8, 8, 3), device="cpu")
    ex = PipelinedExecutor(_sum_step, 2, (8, 8, 3), depth=2, device="cpu")
    with pytest.raises(RuntimeError, match="empty pipeline"):
        ex.drain()
    with pytest.raises(IndexError):
        ex.set_slot(5, None)
    with pytest.raises(IndexError):
        ex.submit({7: np.zeros((8, 8, 3), np.float32)})
    # wrong-shaped frames raise before anything is built or written
    with pytest.raises(ValueError, match="shape"):
        ex.submit({0: np.zeros((16, 16, 3), np.float32), 1: np.zeros((16, 16, 3), np.float32)})
    assert ex.pending == 0 and ex.step_captures == 0 and ex.step_replays == 0
    assert not ex._raw.any()


def test_executor_pipeline_order_and_staleness():
    ex = PipelinedExecutor(_sum_step, 1, (4, 4, 3), depth=3, device="cpu")
    for i in range(3):
        ex.submit({0: np.full((4, 4, 3), float(i), np.float32)}, payload=i)
    assert ex.ready() and ex.pending == 3
    drains = ex.flush()
    assert [d.payload for d in drains] == [0, 1, 2]   # oldest first
    assert [d.seq for d in drains] == [0, 1, 2]
    assert drains[0].staleness == 2                    # waited out 2 submits
    assert [float(d.host[0]) for d in drains] == [0.0, 48.0, 96.0]
    assert ex.step_captures == 1 and ex.step_replays == 3


def test_executor_slots_probe_and_reset():
    """Clean slots keep their content; ``run_direct`` runs over cycled
    frames and leaves the resident batch as it was; ``set_slot(None)``
    blanks; ``reset`` drops the queue and blanks every slot."""
    ex = PipelinedExecutor(_sum_step, 3, (2, 2, 1), depth=1, device="cpu")
    ex.submit({0: np.ones((2, 2, 1), np.float32), 2: np.full((2, 2, 1), 2.0, np.float32)})
    assert list(ex.drain().host) == [4.0, 0.0, 8.0]
    ex.submit({1: np.full((2, 2, 1), 3.0, np.float32)})
    d = ex.drain()
    assert list(d.host) == [4.0, 12.0, 8.0] and d.h2d_bytes == ex.frame_bytes
    probe = ex.run_direct([np.full((2, 2, 1), 5.0, np.float32), np.zeros((2, 2, 1), np.float32)])
    assert list(probe) == [20.0, 0.0, 20.0]
    assert list(ex.run_direct()) == [4.0, 12.0, 8.0]
    ex.set_slot(0, None)
    ex.set_slot(2, np.full((2, 2, 1), 0.5, np.float32))
    assert list(ex.run_direct()) == [0.0, 12.0, 2.0]
    ex.submit({1: np.zeros((2, 2, 1), np.float32)})
    ex.reset()
    assert ex.pending == 0 and not ex._raw.any() and ex.step_captures == 1


# --------------------------------------------- scheduler depth wiring -----
def _tiny_ladder(ref_params):
    rungs = [Rung("one_stage@0.5", "one_stage", 0.5), Rung("early_exit@0.5", "early_exit", 0.5)]
    return calibrate(rungs, CITY, n=3, device="cpu", params=ref_params)


def _sched(ref_params, ladder, **kw):
    return RungBucketScheduler(ladder, device="cpu", params=ref_params, **kw)


def test_scheduler_depth2_pairs_stale_results_with_their_scenes(ref_params):
    ladder = _tiny_ladder(ref_params)
    sched = _sched(ref_params, ladder, capacity=2, depth=2)
    sched.warm()
    sched.add_stream("a", 50.0 * ladder.top.e2e_mean)
    sched.add_stream("b", 50.0 * ladder.top.e2e_mean)
    n_ticks = 4
    rows = []
    for t in range(n_ticks):
        rows.extend(sched.tick({sid: generate_scene(CITY, 10 + t) for sid in sched.streams}).rows)
    tail = sched.flush()
    assert set(tail.outputs) == {"a", "b"}
    assert len(rows) + len(tail.rows) == n_ticks * 2
    assert all(r["staleness"] == 1 for r in rows)
    assert all(r["staleness"] == 0 for r in tail.rows)
    rows.extend(tail.rows)
    assert all(r["quality"] is not None for r in rows)
    assert all(r["latency_s"] > 0 for r in rows)
    for st in sched.streams.values():
        assert st.frames == n_ticks
    assert all(e.trace_count == 1 for e in sched.engines.values())


def test_scheduler_flushes_engine_whose_bucket_emptied(ref_params):
    ladder = _tiny_ladder(ref_params)
    sched = _sched(ref_params, ladder, capacity=1, depth=2)
    sched.warm()
    sched.add_stream("a", 50.0 * ladder.top.e2e_mean)
    sched.tick({"a": generate_scene(CITY, 1)})       # in flight in top rung
    st = sched.streams["a"]
    res = sched.tick({"a": generate_scene(CITY, 2)}, budgets={"a": 1e-9})
    flushed = [r for r in res.rows if r["rung"] == ladder.top.name]
    assert len(flushed) == 1
    assert sched.engines[ladder.top.name].in_flight == 0
    sched.flush()
    assert st.frames == 2


def test_warm_seeds_completion_latency_at_depth(ref_params):
    ladder = _tiny_ladder(ref_params)
    s1 = _sched(ref_params, ladder, capacity=2, depth=1)
    s2 = _sched(ref_params, ladder, capacity=2, depth=2)
    fixed = StageRecord(stages={"inference": 5e-3, "post_processing": 1e-3},
                        meta={"batch_size": 2.0})
    for sched in (s1, s2):
        for eng in sched.engines.values():
            eng.probe = lambda frames=None: StageRecord(stages=dict(fixed.stages),
                                                        meta=dict(fixed.meta))
        sched.warm()
    top = ladder.top.name
    p1 = s1.cost.predict(top, SceneFeatures(batch_size=2.0, batched=True))
    p2 = s2.cost.predict(top, SceneFeatures(batch_size=2.0, batched=True, pipeline_depth=2.0))
    assert s2.cost.model(top).batched_observations == 1
    assert p2.mean == pytest.approx(2.0 * p1.mean)


def test_scheduler_rejects_stage_cost_with_depth(ref_params):
    ladder = _tiny_ladder(ref_params)
    with pytest.raises(ValueError, match="depth"):
        _sched(ref_params, ladder, capacity=2, depth=2, stage_cost=lambda r, s, b, w: 0.0)
    sched = _sched(ref_params, ladder, capacity=2, depth=2)
    with pytest.raises(ValueError, match="depth"):
        sched.set_virtual(SimClock(), lambda r, s, b, w: 0.0)


# ------------------------------------- scheduler parity with the reference --
RUNGS = [("two_stage", "two_stage", 1.0, 0.66), ("one_stage@0.5", "one_stage", 0.5, 0.31),
         ("early_exit@0.5", "early_exit", 0.5, 0.05)]
STAGE_MS = {"two_stage": (0.1, 1.0, 2.0, 3.0), "one_stage@0.5": (0.1, 0.4, 1.5, 0.2),
            "early_exit@0.5": (0.1, 0.3, 0.8, 0.2)}


def _ladder(rung_cls, ladder_cls):
    """The same hand-made ladder on both sides: no wall-clock calibration."""
    stages = ("read", "pre_processing", "inference", "post_processing")
    return ladder_cls([rung_cls(name, pipe, scale, quality=q,
                                stage_means={s: ms * 1e-3 for s, ms in zip(stages, STAGE_MS[name])})
                       for name, pipe, scale, q in RUNGS])


def stage_cost(rung, stage, batch, work):
    """Deterministic modeled stage time: a per-(rung, stage) base, a
    per-slot term and the post stage's proposal work."""
    i = ("read", "inference", "post_processing").index(stage)
    base = STAGE_MS[rung][[0, 2, 3][i]] * 1e-3
    return base * (1.0 + 0.15 * batch) + (2e-5 * work if i == 2 else 0.0)


def test_scheduler_matches_the_reference_under_a_sim_clock(ref_params):
    n_streams, n_ticks = 4, 6
    budgets = [[30e-3, 5e-3, 3.2e-3, 1e-9], [30e-3, 3e-3, 2.4e-3, 9e-3], [2e-3, 30e-3, 1e-9, 4e-3],
               [30e-3, 30e-3, 9e-3, 9e-3], [1e-9, 5e-3, 3e-3, 30e-3], [6e-3, 2.5e-3, 30e-3, 9e-3]]
    scenes = [[generate_scene(SceneConfig(("city", "residential", "road", "city")[s], 4.0 * s,
                                          seed=50 + s), t + 1)
               for s in range(n_streams)] for t in range(n_ticks)]
    scheds = {
        "ref": RScheduler(_ladder(RRung, RLadder), capacity=n_streams, clock=RClock(),
                          stage_cost=stage_cost),
        "port": RungBucketScheduler(_ladder(Rung, Ladder), capacity=n_streams, clock=SimClock(),
                                    stage_cost=stage_cost, device="cpu", params=ref_params),
    }
    results = {k: [] for k in scheds}
    for name, sched in scheds.items():
        sched.warm()
        for s in range(n_streams):
            sched.add_stream(f"cam{s}", 6e-3)
        for t in range(n_ticks):
            results[name].append(sched.tick(
                {f"cam{s}": scenes[t][s] for s in range(n_streams)},
                budgets={f"cam{s}": budgets[t][s] for s in range(n_streams)}))
    rungs_seen = set()
    for want, got in zip(results["ref"], results["port"]):
        assert got.buckets == want.buckets
        assert got.latencies == want.latencies
        rungs_seen |= set(got.buckets)
        assert set(got.outputs) == set(want.outputs)
        for sid in want.outputs:
            a, b = got.outputs[sid], want.outputs[sid]
            assert (a.num_objects, a.num_proposals) == (b.num_objects, b.num_proposals)
            assert a.boxes.shape == b.boxes.shape
            np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-3, rtol=0)
        assert len(got.rows) == len(want.rows)
        for g, w in zip(got.rows, want.rows):
            gq, wq = g.pop("quality"), w.pop("quality")
            assert g == w
            assert (gq is None) == (wq is None)
            if wq is not None:
                assert gq == pytest.approx(wq, abs=QUALITY_TOL)
    assert rungs_seen == {name for name, *_ in RUNGS}
    assert scheds["port"].clock.time() == scheds["ref"].clock.time()
    got, want = scheds["port"].report(), scheds["ref"].report()
    for g, w in zip(got, want):
        gq, wq = g.pop("mean_quality"), w.pop("mean_quality")
        assert g == w
        assert gq == pytest.approx(wq, abs=QUALITY_TOL)
    assert sum(r["switches"] for r in got) > 0
