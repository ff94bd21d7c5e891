"""The batched multi-camera engine of the port (``repro_torch.batched``)
against the JAX reference's (``repro.batched``) on the CPU, on bridged
weights (the reference's key-7 trees through ``params``), at the repo's
perception size (96 × 320 × 3 frames, channels 16, top_k 32).

Bounds: counts equal on every frame; boxes within 1e-3 px of the reference
engine and of the port's own serial ``run_frame`` (the batched path
pre-processes on the device in f32, the serial one on the host in NumPy:
a few f32 ulps at 320 px, well inside 1e-3, as the reference's own test
holds its engine against its serial loop).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.anytime import Rung as RRung, calibrate as rcalibrate  # noqa: E402
from repro.batched import BatchedPerceptionEngine as REngine  # noqa: E402
from repro.perception import build_pipeline as rbuild, detector as rdet, lane as rlane  # noqa: E402
from repro_torch.anytime import Rung, calibrate  # noqa: E402
from repro_torch.batched import BatchedPerceptionEngine, RungBucketScheduler  # noqa: E402
from repro_torch.perception import SceneConfig, build_pipeline, generate_scene, run_frame  # noqa: E402

CITY = SceneConfig("city", seed=21)
BOX = dict(atol=1e-3, rtol=0)
CASES = [("one_stage", 1.0, True), ("one_stage", 0.5, False), ("early_exit", 0.5, False),
         ("two_stage", 1.0, True), ("lane", 1.0, True), ("lane_static", 1.0, True)]


@pytest.fixture(scope="module")
def ref_params():
    """Reference weights per pipeline, as its factories draw them (key 7)."""
    key = jax.random.PRNGKey(7)
    tree = lambda det: jax.tree.map(np.asarray, det.init(key))
    one, lane = tree(rdet.OneStageDetector()), tree(rlane.LaneDetector())
    return {"one_stage": one, "early_exit": one, "two_stage": tree(rdet.TwoStageDetector()),
            "lane": lane, "lane_static": lane}


def same_output(got, want):
    assert (got.num_objects, got.num_proposals) == (want.num_objects, want.num_proposals)
    assert got.boxes.shape == want.boxes.shape
    np.testing.assert_allclose(got.boxes, want.boxes, **BOX)


@pytest.mark.parametrize("name,scale,pad", CASES)
def test_batched_matches_serial_per_rung(ref_params, name, scale, pad):
    """The batched device path (device pre-processing + inference with the
    slot axis written out, vectorized or per-slot post) reproduces the
    reference's batched engine and the port's own serial pipeline, per
    slot, with three different scenes in the three slots."""
    reng = REngine(rbuild(name, scale=scale, pad=pad), capacity=3)
    teng = BatchedPerceptionEngine(name, capacity=3, scale=scale, pad=pad, device="cpu",
                                   params=ref_params)
    scenes = [generate_scene(SceneConfig(sc, seed=21), i + 1)
              for i, sc in enumerate(("city", "residential", "road"))]
    frames = {f"cam{s}": scenes[s].image for s in range(3)}
    outs = {}
    for eng in (reng, teng):
        for s in range(3):
            eng.join(f"cam{s}")
        outs[eng] = eng.tick(frames)[1]
    for s, scene in enumerate(scenes):
        got = outs[teng][f"cam{s}"]
        same_output(got, outs[reng][f"cam{s}"])
        same_output(got, run_frame(teng.built, scene)[1])
    assert teng.trace_count == 1 and teng.replay_count == 1


def test_an_empty_slot_does_not_move_its_neighbours(ref_params):
    """Each slot is normalised and suppressed on its own: a blank slot
    beside a frame leaves that frame's outputs as they are alone."""
    img = generate_scene(CITY, 3).image
    alone = BatchedPerceptionEngine("one_stage", capacity=1, device="cpu", params=ref_params)
    pair = BatchedPerceptionEngine("one_stage", capacity=2, device="cpu", params=ref_params)
    alone.join("a")
    pair.join("z")
    pair.join("a")                       # slot 1; slot 0 stays blank
    want, got = alone.tick({"a": img})[1]["a"], pair.tick({"a": img})[1]["a"]
    same_output(got, want)
    assert got.num_objects > 0


def test_no_new_capture_on_join_and_leave(ref_params):
    """Slot carve-out from the fixed-capacity padded batch: stream churn
    never builds the step again, and every tick runs it once."""
    eng = BatchedPerceptionEngine("early_exit", capacity=4, device="cpu", params=ref_params)
    img = generate_scene(CITY, 1).image
    eng.compile()
    eng.join("a")
    eng.join("b")
    eng.tick({"a": img, "b": img})
    eng.join("c")                          # join mid-flight
    eng.tick({"a": img, "b": img, "c": img})
    eng.leave("b")
    eng.tick({"a": img, "c": img})
    eng.leave("a")
    eng.leave("c")
    eng.join("d")                          # rejoin after full drain
    _, outs = eng.tick({"d": img})
    assert eng.trace_count == 1 and eng.executor.step_captures == 1
    assert eng.replay_count == eng.ticks == 4
    assert set(outs) == {"d"}
    assert eng.aggregate_report()["traces"] == 1


def test_engine_slot_exhaustion_and_double_join():
    eng = BatchedPerceptionEngine("early_exit", capacity=1, device="cpu")
    eng.join("a")
    with pytest.raises(ValueError, match="already seated"):
        eng.join("a")
    with pytest.raises(RuntimeError, match="no free slot"):
        eng.join("b")
    with pytest.raises(KeyError, match="unseated"):
        eng.tick({"ghost": generate_scene(CITY, 1).image})
    # a frameless tick serves nothing: no device step, no logged tick
    rec, outs = eng.tick({})
    assert rec is None and outs == {}
    assert eng.ticks == 0 and eng.tick_log == [] and eng.replay_count == 0
    # build arguments alongside an already-built pipeline are contradictory
    with pytest.raises(ValueError, match="already built"):
        BatchedPerceptionEngine(build_pipeline("early_exit", device="cpu"), capacity=1, scale=0.5)
    with pytest.raises(ValueError, match="capacity"):
        BatchedPerceptionEngine("early_exit", capacity=0, device="cpu")


def test_reset_keeps_the_step_and_blanks_the_slots(ref_params):
    eng = BatchedPerceptionEngine("one_stage", capacity=2, device="cpu", params=ref_params)
    img = generate_scene(CITY, 2).image
    eng.join("a")
    first = eng.tick({"a": img})[1]["a"]
    eng.reset()
    assert (eng.n_active, eng.n_free, eng.ticks) == (0, 2, 0)
    assert not eng.executor._raw.any()
    eng.join("b")
    same_output(eng.tick({"b": img})[1]["b"], first)
    assert eng.trace_count == 1


def test_shard_bookkeeping_is_one_shard():
    eng = BatchedPerceptionEngine("early_exit", capacity=3, device="cpu")
    for sid in ("a", "b"):
        eng.join(sid)
    assert eng.n_shards == 1 and eng.shard_occupancy() == [2]
    assert eng.streams_on(0) == ["a", "b"] and eng.shard_of("b") == 0
    assert eng.migrate("a", 0) is eng.active["a"]
    with pytest.raises(ValueError, match="out of range"):
        eng.join("c", shard=1)


# ------------------------------------------- rung-bucketed scheduling -----
def _tiny_ladder(ref_params):
    rungs = [Rung("one_stage@0.5", "one_stage", 0.5), Rung("early_exit@0.5", "early_exit", 0.5)]
    return calibrate(rungs, CITY, n=3, device="cpu", params=ref_params)


def test_rung_bucket_scheduling_splits_by_budget(ref_params):
    ladder = _tiny_ladder(ref_params)
    sched = RungBucketScheduler(ladder, capacity=3, device="cpu", params=ref_params)
    sched.warm()
    top = ladder.top
    sched.add_stream("loose0", 50.0 * top.e2e_mean)
    sched.add_stream("loose1", 50.0 * top.e2e_mean)
    sched.add_stream("tight", 1e-9)            # nothing can fit: floor rung
    last = None
    for t in range(4):
        last = sched.tick({sid: generate_scene(CITY, 10 + t) for sid in sched.streams})
    assert set(last.buckets) == {ladder.top.name, ladder.floor.name}
    assert sorted(last.buckets[ladder.top.name]) == ["loose0", "loose1"]
    assert last.buckets[ladder.floor.name] == ["tight"]
    rows = {r["stream"]: r for r in last.rows}
    assert rows["loose0"]["latency_s"] == rows["loose1"]["latency_s"]
    assert rows["loose0"]["batch_size"] == 2
    # membership churn across buckets never built a step twice
    assert all(e.trace_count == 1 for e in sched.engines.values())
    assert sched.cost.model(ladder.floor.name).batched_observations > 0
    # the same ladder calibrated by the reference orders its rungs alike
    rladder = rcalibrate([RRung("one_stage@0.5", "one_stage", 0.5),
                          RRung("early_exit@0.5", "early_exit", 0.5)], CITY, n=3)
    assert [r.name for r in rladder] == [r.name for r in ladder]
    assert [r.quality for r in ladder] == pytest.approx([r.quality for r in rladder], abs=5e-4)


def test_scheduler_stream_lifecycle(ref_params):
    ladder = _tiny_ladder(ref_params)
    sched = RungBucketScheduler(ladder, capacity=2, device="cpu", params=ref_params)
    sched.add_stream("a", 1.0)
    with pytest.raises(ValueError, match="already exists"):
        sched.add_stream("a", 1.0)
    sched.add_stream("b", 1.0)
    with pytest.raises(RuntimeError, match="at capacity"):
        sched.add_stream("c", 1.0)
    sched.tick({"a": generate_scene(CITY, 1), "b": generate_scene(CITY, 2)})
    sched.remove_stream("a")
    assert all("a" not in e.active for e in sched.engines.values())
    res = sched.tick({"b": generate_scene(CITY, 3)})
    assert set(res.outputs) == {"b"}
    assert sched.streams["b"].drops == 0
    with pytest.raises(KeyError, match="unknown streams"):
        sched.tick({"a": generate_scene(CITY, 4)})
    sched.add_stream("c", 1.0)
    sched.tick({"b": generate_scene(CITY, 5)})         # c seated, no frame
    assert sched.streams["c"].drops == 1
    assert [r["stream"] for r in sched.report()] == ["b", "c"]
    assert sched.report()[1]["miss_rate"] is None      # json_num of nan


# ----------------------------------------------------------------- device --
def test_cuda_without_a_card_raises(monkeypatch, ref_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedPerceptionEngine("one_stage")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RungBucketScheduler(_tiny_ladder(ref_params), capacity=2)
    from repro_torch.batched import PipelinedExecutor
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelinedExecutor(lambda raw: raw, 2, (4, 4, 3))


# ------------------------------------------------------------ fleet placer --
def test_fleet_placer_matches_the_reference():
    """The placer is pure Python on the shared cost model: on the same
    ladder and the same batched observations, the same seats and moves."""
    from repro.anytime import Ladder as RLadder
    from repro.anytime.cost import LadderCostModel as RCost, SceneFeatures as RFeats
    from repro.batched.fleet import FleetPlacer as RPlacer
    from repro.core.timing import StageRecord as RRecord
    from repro_torch.anytime import Ladder
    from repro_torch.anytime.cost import LadderCostModel, SceneFeatures
    from repro_torch.batched.fleet import FleetPlacer
    from repro_torch.core.timing import StageRecord

    means = {"read": 1e-4, "pre_processing": 5e-4, "inference": 3e-3, "post_processing": 1e-3}
    sides = []
    for rung, ladder, cost, feats, record, placer in (
            (RRung, RLadder, RCost, RFeats, RRecord, RPlacer),
            (Rung, Ladder, LadderCostModel, SceneFeatures, StageRecord, FleetPlacer)):
        lad = ladder([rung("top", "two_stage", 1.0, quality=0.7, stage_means=means),
                      rung("low", "early_exit", 0.5, quality=0.1,
                           stage_means={k: v / 3 for k, v in means.items()})])
        model = cost(lad)
        for b in (1, 2, 3, 4):
            model.observe("top", record(stages={"inference": 2e-3 + 1e-3 * b},
                                        meta={"batch_size": float(b)}),
                          feats(batch_size=float(b), batched=True))
        p = placer(model, 3, pipeline_depth=1)
        seats = [p.place(r, occ, 4) for r in ("top", "low")
                 for occ in ([0, 0, 0], [2, 1, 3], [4, 1, 1], [4, 4, 3])]
        moves = [p.rebalance("top", occ) for occ in ([3, 1, 2], [2, 2, 1], [0, 4, 1])]
        p.mark_dead(1)
        seats.append(p.place("top", [2, 0, 3], 4))
        moves.append(p.rebalance("top", [0, 4, 3]))
        with pytest.raises(RuntimeError, match="alive shards full"):
            p.place("top", [4, 0, 4], 4)
        with pytest.raises(ValueError):
            placer(model, 0)
        sides.append((seats, moves))
    assert sides[1] == sides[0]
    assert sides[1][0][:4] == [0, 1, 1, 2] and sides[1][1][0] == (0, 1)
