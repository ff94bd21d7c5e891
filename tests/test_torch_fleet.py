"""The port's multi-shard camera fleet against the JAX reference, on the CPU:
the mesh helpers (``repro_torch.launch.mesh``, ``repro_torch.distributed``),
the engine's per-shard bookkeeping, the sharded executor, a one-shard mesh
replay, and an 8-stream fleet at two shards.

The reference cannot run two shards itself under this JAX: its sharded
jit of the perception step raises ``ShardingTypeError`` on a forced
two-device host (ROADMAP.md Queue 3).  Its host logic at two shards runs
over its one-device program, though: the slot-batch step is data-parallel
(a slot's outputs do not depend on which device computes them) and the
replay's stage costs are modelled from the shard split, not read from the
device.  So the oracle is the reference with ``data_shards`` patched to 2
in its executor and scheduler (``mesh=None``), in the test only.  The
port's two CPU shards (``devices=["cpu", "cpu"]``) are held against it:
buckets, per-shard buckets, seats, ``shard_serve`` spans, ``shard_migrate``
instants and ledger rows equal; report rows equal but ``mean_quality``,
within 5e-4 (as ``tests/test_torch_chaos.py``; measured about 5e-9).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.batched.executor as rexecutor  # noqa: E402
import repro.batched.scheduler as rscheduler  # noqa: E402
from repro import chaos as rchaos  # noqa: E402
from repro.batched.engine import BatchedPerceptionEngine as REngine  # noqa: E402
from repro.bus.clock import SimClock as RSimClock  # noqa: E402
from repro.distributed import sharding as rsharding  # noqa: E402
from repro.launch import mesh as rmesh  # noqa: E402
from repro.obs import Observatory as RObservatory  # noqa: E402
from repro.perception import data as rdata  # noqa: E402
from repro.perception import detector as rdet  # noqa: E402
from repro.perception.pipelines import build_pipeline as rbuild  # noqa: E402
from repro.scenarios import replay as rreplay  # noqa: E402

from repro_torch import chaos  # noqa: E402
from repro_torch import perception  # noqa: E402
from repro_torch.batched import BatchedPerceptionEngine, PipelinedExecutor, \
    RungBucketScheduler  # noqa: E402
from repro_torch.bus import SimClock  # noqa: E402
from repro_torch.distributed import axis_size, data_shards, slot_batch_spec  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_local_mesh, parse_mesh_spec  # noqa: E402
from repro_torch.obs import Observatory  # noqa: E402
from repro_torch.perception import build_pipeline  # noqa: E402
from repro_torch.scenarios import ModeledStageCost, ScenarioReplayer, compile_trace, \
    get_episode, replay_ladder  # noqa: E402
from repro_torch.scenarios.golden import GOLDEN_CAPACITY, GOLDEN_EPISODES, \
    GOLDEN_TICK_SCALE  # noqa: E402

QUALITY_TOL = 5e-4
TWO_CPU = ["cpu", "cpu"]


class FakeMesh:
    """Just what the spec helpers read: ``.shape`` and ``.axis_names``."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.fixture(scope="module")
def ref_params():
    key = jax.random.PRNGKey(7)
    tree = lambda det: jax.tree.map(np.asarray, det.init(key))  # noqa: E731
    one = tree(rdet.OneStageDetector())
    return {"one_stage": one, "early_exit": one, "two_stage": tree(rdet.TwoStageDetector())}


@pytest.fixture
def two_shard_oracle(monkeypatch):
    """The reference's executor and scheduler at two shards over its
    one-device program (module docstring)."""
    monkeypatch.setattr(rexecutor, "data_shards", lambda mesh: 2)
    monkeypatch.setattr(rscheduler, "data_shards", lambda mesh: 2)


# ------------------------------------------------------------ mesh CLI ----
@pytest.mark.parametrize("spec", ["data=4", "data=4,model=2", " data = 8 ", "model=2,data=1,"])
def test_parse_mesh_spec_is_the_reference_s(spec):
    assert parse_mesh_spec(spec) == rmesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("bad", ["pod=2", "data=x", "", "data", ",", "data=2,model=y"])
def test_parse_mesh_spec_rejects_as_the_reference(bad):
    with pytest.raises(ValueError) as got:
        parse_mesh_spec(bad)
    with pytest.raises(ValueError) as want:
        rmesh.parse_mesh_spec(bad)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------- local mesh ---
def test_make_local_mesh_factors_down_preserving_model():
    # one CPU device, as the reference's one JAX CPU device: data shrinks
    mesh = make_local_mesh(data=4, model=1, device="cpu")
    want = rmesh.make_local_mesh(data=4, model=1)
    assert mesh.shape == dict(want.shape) == {"data": 1, "model": 1}
    assert mesh.axis_names == tuple(want.axis_names) == ("data", "model")
    assert mesh.devices.shape == (1, 1) and mesh.devices[0, 0] == torch.device("cpu")


@pytest.mark.parametrize("data,model,n,shape", [(2, 1, 2, (2, 1)), (4, 2, 8, (4, 2)),
                                                (4, 4, 8, (2, 4)), (3, 1, 2, (2, 1)),
                                                (2, 2, 3, (1, 2)), (1, 1, 4, (1, 1))])
def test_make_local_mesh_over_a_device_list(data, model, n, shape):
    """A list may name one device more than once; ``data`` shrinks to
    ``n // model`` and the mesh keeps the list's first devices in order."""
    mesh = make_local_mesh(data=data, model=model, devices=["cpu"] * n)
    assert mesh.devices.shape == shape and mesh.shape == {"data": shape[0], "model": shape[1]}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert data_shards(mesh) == shape[0]


def test_make_local_mesh_model_overflow_is_an_error():
    with pytest.raises(ValueError, match="cannot be honored: only 1 device.*--mesh-devices"):
        make_local_mesh(data=1, model=2, device="cpu")
    with pytest.raises(ValueError, match="cannot be honored"):
        rmesh.make_local_mesh(data=1, model=2)
    with pytest.raises(ValueError, match="only 2 device"):
        make_local_mesh(model=3, devices=TWO_CPU)


@pytest.mark.parametrize("kw", [dict(data=0), dict(model=0), dict(data=-1, model=2)])
def test_make_local_mesh_rejects_nonpositive_axes_as_the_reference(kw):
    with pytest.raises(ValueError) as got:
        make_local_mesh(**kw, device="cpu")
    with pytest.raises(ValueError) as want:
        rmesh.make_local_mesh(**kw)
    assert str(got.value) == str(want.value)


def test_make_local_mesh_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_local_mesh(data=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_local_mesh(data=2, devices=["cuda:0", "cuda:0"])


def test_mesh_validates_its_device_array():
    with pytest.raises(ValueError):
        Mesh(np.empty((2,), dtype=object))


# ----------------------------------------------------- sharding helpers ---
@pytest.mark.parametrize("shape", [{"data": 4, "model": 2}, {"model": 2}, {"data": 1},
                                   {"pod": 2, "data": 3}])
def test_data_shards_and_axis_size_are_the_reference_s(shape):
    mesh = FakeMesh(shape)
    assert data_shards(mesh) == rsharding.data_shards(mesh)
    for phys in (None, *shape, tuple(shape)):
        assert axis_size(mesh, phys) == rsharding.axis_size(mesh, phys)


def test_data_shards_of_local_meshes():
    assert data_shards(None) == rsharding.data_shards(None) == 1
    assert data_shards(make_local_mesh(data=1, device="cpu")) == 1
    assert data_shards(make_local_mesh(data=2, devices=TWO_CPU)) == 2


@pytest.mark.parametrize("shape,capacity,want", [(None, 8, ()), ({"data": 1}, 7, ()),
                                                 ({"data": 2}, 8, ("data",)),
                                                 ({"data": 4, "model": 2}, 4, ("data",)),
                                                 ({"model": 2}, 3, ())])
def test_slot_batch_spec(shape, capacity, want):
    mesh = FakeMesh(shape) if shape is not None else None
    assert slot_batch_spec(mesh, capacity) == want
    assert tuple(rsharding.slot_batch_spec(mesh, capacity)) == want


@pytest.mark.parametrize("n,capacity", [(2, 7), (4, 6), (3, 8)])
def test_ragged_slot_split_raises_as_the_reference(n, capacity):
    mesh = FakeMesh({"data": n})
    with pytest.raises(ValueError, match="divisible") as got:
        slot_batch_spec(mesh, capacity)
    with pytest.raises(ValueError) as want:
        rsharding.slot_batch_spec(mesh, capacity)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="divisible"):
        PipelinedExecutor(lambda raw: raw, capacity, (4, 4, 3), device="cpu",
                          mesh=make_local_mesh(data=n, devices=["cpu"] * n))


# ------------------------------------------------ engine shard accounting --
def _bookkeeping_script(eng):
    """Joins (least occupied, ties to the lower shard; pinned), migrations,
    leaves and every refusal at two shards of two slots; a snapshot after
    each step."""
    out = []

    def snap(tag, value=None):
        out.append((tag, value, {s: (st.slot, eng.shard_of(s)) for s, st in eng.active.items()},
                    eng.shard_occupancy(), eng.n_free, [eng.streams_on(k) for k in range(2)]))

    def refused(tag, fn, exc):
        with pytest.raises(exc) as err:
            fn()
        snap(tag, type(err.value).__name__)

    eng.reset()
    assert eng.n_shards == 2 and eng.slots_per_shard == 2
    for sid in ("cam0", "cam1", "cam2"):
        snap(f"join {sid}", eng.join(sid).slot)
    refused("join pinned to a full shard", lambda: eng.join("cam3", shard=0), RuntimeError)
    refused("join out of range", lambda: eng.join("cam3", shard=2), ValueError)
    refused("join twice", lambda: eng.join("cam0"), ValueError)
    snap("migrate to its own shard", eng.migrate("cam0", 0).slot)
    refused("migrate to a full shard", lambda: eng.migrate("cam1", 0), RuntimeError)
    refused("migrate out of range", lambda: eng.migrate("cam1", 5), ValueError)
    snap("leave cam0", eng.leave("cam0").slot)
    snap("migrate cam1", eng.migrate("cam1", 0).slot)
    snap("join pinned", eng.join("cam3", shard=1).slot)
    snap("join cam4", eng.join("cam4").slot)
    refused("join into a full batch", lambda: eng.join("cam5"), RuntimeError)
    for sid in ("cam1", "cam2", "cam3", "cam4"):
        snap(f"leave {sid}", eng.leave(sid).slot)
    return out


def test_engine_two_shard_bookkeeping_is_the_reference_s(two_shard_oracle):
    got = _bookkeeping_script(BatchedPerceptionEngine(
        "early_exit", capacity=4, pad=False, device="cpu",
        mesh=make_local_mesh(data=2, devices=TWO_CPU)))
    want = _bookkeeping_script(REngine(rbuild("early_exit", pad=False), capacity=4))
    assert got == want
    # the two shards' blocks are [0, 2) and [2, 4); cam2 went to shard 0 on the tie
    assert [s[2] for s in got[:3]] == [{"cam0": (0, 0)}, {"cam0": (0, 0), "cam1": (2, 1)},
                                       {"cam0": (0, 0), "cam1": (2, 1), "cam2": (1, 0)}]
    assert got[-1][3] == [0, 0] and got[-1][4] == 4


def test_engine_shard_tick_serves_every_block_and_blanks_on_leave():
    eng = BatchedPerceptionEngine("one_stage", capacity=4, device="cpu",
                                  mesh=make_local_mesh(data=2, devices=TWO_CPU))
    img = perception.generate_scene(perception.SceneConfig("city", seed=3), 1).image
    for sid, shard in (("a", 0), ("b", 1), ("c", 1)):
        eng.join(sid, shard=shard)
    _, outs = eng.tick({"a": img, "b": img, "c": img})
    assert set(outs) == {"a", "b", "c"}
    assert all(np.array_equal(outs[s].boxes, outs["a"].boxes) for s in "bc")
    eng.migrate("c", 0)
    eng.leave("b")
    assert not eng.executor._raw[2:].any() and eng.executor._raw[0].any()
    _, outs = eng.tick({"c": img})
    assert set(outs) == {"c"} and np.array_equal(outs["c"].boxes, outs["c"].boxes)
    # one capture per shard, one replay per shard and submit
    assert (eng.trace_count, eng.replay_count, eng.ticks) == (2, 4, 2)


# ---------------------------------------------------------- the executor ---
def _frames(n, seed0=40):
    return [perception.generate_scene(perception.SceneConfig(
        ("city", "road", "residential")[i % 3], seed=seed0 + i), i + 1).image for i in range(n)]


@pytest.mark.parametrize("name,scale,pad", [("two_stage", 1.0, True), ("one_stage", 0.75, False),
                                            ("lane_static", 1.0, True)])
@pytest.mark.parametrize("depth", [1, 2])
def test_two_shard_executor_is_one_shard_bit_for_bit(name, scale, pad, depth):
    """Slots split 4 + 4 over two CPU shards give the one-shard executor's
    outputs bit for bit at depth 1 and 2 (the CPU's convolutions do not
    depend on the batch size here), probes included."""
    built = build_pipeline(name, scale=scale, pad=pad, device="cpu")
    frames = _frames(12)
    seqs = {}
    for mesh in (None, make_local_mesh(data=2, devices=TWO_CPU)):
        ex = PipelinedExecutor(built.device_step, 8, frames[0].shape, depth=depth, device="cpu",
                               mesh=mesh)
        got = []
        for t in range(3):
            ex.submit({(3 * t + s) % 8: frames[4 * t + s] for s in range(4)}, payload=t)
            if ex.ready():
                got.append(ex.drain())
        got += ex.flush()
        assert [d.payload for d in got] == [0, 1, 2]
        probe = ex.run_direct(frames[:5])
        seqs[mesh is None] = [[np.array(a) for a in d.host] for d in got] + [list(probe)]
        assert ex.step_captures == ex.n_shards and ex.step_replays == 4 * ex.n_shards
    for a, b in zip(seqs[False], seqs[True]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_pipeline_replica_is_the_same_pipeline():
    built = build_pipeline("early_exit", pad=False, device="cpu")
    assert built.on("cpu") is built
    copy = built.replicate(torch.device("cpu"))
    assert copy is not built and copy.name == "early_exit"
    raw = torch.from_numpy(np.stack(_frames(2)))
    for x, y in zip(built.device_step(raw), copy.device_step(raw)):
        assert torch.equal(x, y)


# ------------------------------------------------ 1-shard mesh == meshless --
@pytest.mark.parametrize("name", sorted(GOLDEN_EPISODES))
def test_one_shard_mesh_replay_byte_identical(name):
    """A data=1 mesh leaves the replay report byte-identical to the meshless
    replay (every sharded behaviour is gated on n_shards > 1)."""
    trace = compile_trace(get_episode(name), seed=GOLDEN_EPISODES[name],
                          tick_scale=GOLDEN_TICK_SCALE)
    plain = ScenarioReplayer(trace, capacity=GOLDEN_CAPACITY, device="cpu").run()
    sharded = ScenarioReplayer(trace, capacity=GOLDEN_CAPACITY, device="cpu",
                               mesh=make_local_mesh(data=1, device="cpu"))
    assert sharded.scheduler.n_shards == 1
    assert sharded.run().to_json(indent=2) == plain.to_json(indent=2)


# ---------------------------------------------------- fleet 8 x 40 ticks ---
FLEET_SIDS = [f"cam{i:02d}" for i in range(8)]
FLEET_TICKS = 40


def _fleet(sched, clock, cost, obs, chaos_mod, data_mod, sids=FLEET_SIDS):
    """serve_fleet's loop (launch/serve.py) with shard_loss_rush_hour's plan
    compiled over the fleet: each tick's buckets, per-shard buckets and
    seats, the shard spans and instants, the ledger and the report."""
    obs.bind_clock(clock)
    sched.set_obs(obs)
    sched.warm(data_mod.SceneConfig(scenario="city", seed=7))
    for sid in sids:
        sched.add_stream(sid, 0.03)
    ep = chaos_mod.get_chaos_episode("shard_loss_rush_hour")
    ledger = chaos_mod.ChaosLedger()
    injector = chaos_mod.FaultInjector(
        chaos_mod.compile_plan(ep.spec, sids, FLEET_TICKS, seed=ep.seed), ledger=ledger)
    sched.attach_resilience(chaos_mod.FleetResilience(ledger=ledger))
    rng = np.random.default_rng(0)
    ticks = []
    for t in range(FLEET_TICKS):
        scenes = {sid: data_mod.generate_scene(data_mod.SceneConfig(
            scenario="city", rain_mm_per_hour=float(rng.choice([0.0, 0.0, 4.0])), seed=i), t)
            for i, sid in enumerate(sids)}
        cost.contention = injector.latency_scale(t)
        injector.pre_tick(t, sched)
        res = sched.tick(injector.filter_scenes(t, scenes))
        ticks.append((res.buckets, res.shard_buckets,
                      {n: {s: e.shard_of(s) for s in e.active} for n, e in sched.engines.items()}))
    spans = [(s.name, s.tick, s.rung, s.shard, s.batch_size, s.stream, s.t0, s.t1)
             for s in obs.tracer.spans() if s.name in ("shard_serve", "shard_migrate")]
    return ticks, spans, [(e.tick, e.kind, e.stream, e.shard, e.detail) for e in ledger.events], \
        sched.report()


@pytest.mark.parametrize("capacity", [8, 16], ids=["pressure", "room"])
def test_fleet_at_two_shards_matches_the_oracle(ref_params, two_shard_oracle, capacity):
    """Capacity 8: the kill unseats shard 1's four streams (no room on
    shard 0) and the next join re-seats them.  Capacity 16: they fail over
    by migration, and after the revive the rebalance moves one stream a
    tick back.  Placement, migrations and spans as the reference's."""
    clock, cost = SimClock(), ModeledStageCost(replay_ladder(), seed=0)
    got = _fleet(RungBucketScheduler(replay_ladder(), capacity=capacity, clock=clock,
                                     stage_cost=cost, device="cpu", params=ref_params,
                                     mesh=make_local_mesh(data=2, devices=TWO_CPU)),
                 clock, cost, Observatory(), chaos, perception)
    rclock, rcost = RSimClock(), rreplay.ModeledStageCost(rreplay.replay_ladder(), seed=0)
    want = _fleet(rscheduler.RungBucketScheduler(rreplay.replay_ladder(), capacity=capacity,
                                                 clock=rclock, stage_cost=rcost),
                  rclock, rcost, RObservatory(), rchaos, rdata)
    assert got[0] == want[0]
    assert got[1] == want[1] and got[2] == want[2]
    for a, b in zip(got[3], want[3]):
        assert a.pop("mean_quality") == pytest.approx(b.pop("mean_quality"), abs=QUALITY_TOL)
        assert a == b
    migrations = [s for s in got[1] if s[0] == "shard_migrate"]
    serves = [s for s in got[1] if s[0] == "shard_serve"]
    assert serves and {s[3] for s in serves} == {0, 1}
    kinds = [k for _, k, *_ in got[2]]
    if capacity == 8:
        assert kinds.count("degrade") == kinds.count("failover") == 4 and not migrations
    else:
        assert kinds.count("failover") == 4 and "degrade" not in kinds and len(migrations) >= 4


def test_unseatable_join_under_chaos_matches_the_oracle(ref_params, two_shard_oracle):
    """One rung, capacity 4, four streams: the kill unseats shard 1's two
    streams, and with no rung below theirs they ask for the same engine,
    whose only alive shard is full.  The join cannot seat them: their
    frames drop each tick (the bucket serves the rest) until the revive,
    when the join lands with the shard it seats on, as the reference's."""
    sids = FLEET_SIDS[:4]
    clock, cost = SimClock(), ModeledStageCost(replay_ladder(["early_exit@0.5"]), seed=0)
    got = _fleet(RungBucketScheduler(replay_ladder(["early_exit@0.5"]), capacity=4, clock=clock,
                                     stage_cost=cost, device="cpu", params=ref_params,
                                     mesh=make_local_mesh(data=2, devices=TWO_CPU)),
                 clock, cost, Observatory(), chaos, perception, sids)
    rclock = RSimClock()
    rcost = rreplay.ModeledStageCost(rreplay.replay_ladder(["early_exit@0.5"]), seed=0)
    want = _fleet(rscheduler.RungBucketScheduler(rreplay.replay_ladder(["early_exit@0.5"]),
                                                 capacity=4, clock=rclock, stage_cost=rcost),
                  rclock, rcost, RObservatory(), rchaos, rdata, sids)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    for a, b in zip(got[3], want[3]):
        assert a.pop("mean_quality") == pytest.approx(b.pop("mean_quality"), abs=QUALITY_TOL)
        assert a == b
    drops = {r["stream"]: r["drops"] for r in got[3]}
    assert sorted(drops.values()) == [0, 0, 12, 12]       # ticks 8 to 19 unseated
    reseats = [(t, sh) for t, k, _, sh, d in got[2] if k == "failover"]
    assert [t for t, _ in reseats] == [20, 20] and {sh for _, sh in reseats} == {1}


def test_serve_fleet_cli_at_two_shards(tmp_path, capsys):
    from repro_torch.launch import serve
    path = tmp_path / "fleet.json"
    serve.main(["--fleet", "--streams", "3", "--ticks", "12", "--device", "cpu",
                "--mesh", "data=2", "--mesh-devices", "cpu,cpu",
                "--chaos", "shard_loss_rush_hour", "--json-out", str(path)])
    out = capsys.readouterr().out
    doc = json.loads(path.read_text())
    # capacity rounds 3 up to a multiple of the shard count
    assert doc["n_shards"] == 2 and doc["capacity"] == 4 and doc["mesh"] == "data=2"
    assert doc["mesh_devices"] == TWO_CPU and "on 2 shard(s)" in out
    assert set(doc["trace_counts"].values()) == {2}
    assert all(len(occ) == 2 for occ in doc["shard_occupancy"].values())
    assert doc["chaos"]["counts"]["fault_inject"] == 1          # the kill at tick 8
    assert doc["chaos"]["counts"]["failover"] >= 1
