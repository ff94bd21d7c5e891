"""The observability layer of the port (``repro_torch.obs`` and the
``core.timing`` adapters) against the reference's (``repro.obs``): the
same span, metric and sketch sequences go through both, and what comes out
must be equal — spans, Chrome traces, sketch bins and the string tables
exactly, float64 statistics to 1e-12 (relative; the two sides run the same
Python arithmetic, so in practice they are equal to the bit).  Last, the
batched engine's tick spans: the same ticks under a SimClock give the same
span names, axes, tracks, parents and times on both sides.
"""
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import obs as robs  # noqa: E402
from repro.bus import SimClock as RClock  # noqa: E402
from repro.core import timing as rtiming  # noqa: E402
from repro.obs.__main__ import MEDIATED_ORDER  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.bus import SimClock as TClock  # noqa: E402
from repro_torch.core import timing as ttiming  # noqa: E402

SIDES = {"ref": (robs, RClock, rtiming), "port": (tobs, TClock, ttiming)}
F64 = dict(rel=1e-12, abs=0.0)


def both(fn):
    """``fn(obs, SimClock, timing)`` on the reference's modules and on the
    port's; returns (reference result, port result)."""
    return fn(*SIDES["ref"]), fn(*SIDES["port"])


def assert_close_tree(a, b):
    """Equal structure and strings; floats to 1e-12 relative."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_close_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_close_tree(x, y)
    elif isinstance(a, float) and not np.isnan(a):
        assert b == pytest.approx(a, **F64)
    elif isinstance(a, float):
        assert np.isnan(b)
    else:
        assert a == b


# ------------------------------------------------------------- tracer --

def test_span_record_tags_and_duration():
    def run(obs, Clock, _):
        tr = obs.SpanTracer(capacity=16, clock=Clock().time)
        s = tr.record("inference", 1.0, 1.5, stream="cam0", tick=3, rung="two_stage",
                      batch_size=4, axis="model", track=1)
        assert s.duration == pytest.approx(0.5) and s.parent == -1
        return [x.to_dict() for x in tr.spans()]

    want, got = both(run)
    assert got == want and got[0]["tick"] == 3 and got[0]["seq"] == 0


def test_span_rejects_unknown_axis():
    for obs, _, timing in SIDES.values():
        tr = obs.SpanTracer(capacity=4)
        with pytest.raises(ValueError, match="unknown axis"):
            tr.record("x", 0.0, 1.0, axis="gpu")
        with pytest.raises(ValueError, match="unknown axis"):
            with tr.span("x", axis="nope"):
                pass
        assert set(timing.STAGE_AXES.values()) <= set(tobs.AXES)
    assert ttiming.STAGE_AXES == rtiming.STAGE_AXES
    from repro.analysis.findings import AXES
    assert tobs.AXES == AXES


def test_span_nesting_assigns_parents():
    def run(obs, Clock, _):
        clock = Clock()
        tr = obs.SpanTracer(capacity=16, clock=clock.time)
        with tr.span("tick", axis="end_to_end"):
            clock.advance(0.1)
            with tr.span("inference", axis="model"):
                clock.advance(0.2)
            tr.instant("rung_switch", axis="model")
            clock.advance(0.05)
        return [s.to_dict() for s in tr.spans()]

    want, got = both(run)
    assert got == want
    spans = {s["name"]: s for s in got}
    assert spans["inference"]["parent"] == spans["tick"]["seq"] == spans["rung_switch"]["parent"]
    assert [s["name"] for s in got] == ["inference", "rung_switch", "tick"]


def test_ring_overwrites_oldest_and_counts_drops():
    def run(obs, _, __):
        tr = obs.SpanTracer(capacity=4)
        for i in range(7):
            tr.record(f"s{i}", float(i), float(i) + 0.5)
        out = (tr.n_recorded, tr.dropped, [s.to_dict() for s in tr.spans()])
        tr.clear()
        return out + (tr.n_recorded, tr.dropped, tr.spans())

    want, got = both(run)
    assert got == want
    assert got[:2] == (7, 3) and [s["name"] for s in got[2]] == ["s3", "s4", "s5", "s6"]


def test_span_fence_waits_for_the_value_named_at_exit(monkeypatch):
    """The port's fence is ``core.timing.fence``, called on the value the
    callable names when the span closes (the reference blocks on it)."""
    seen = []
    monkeypatch.setattr(tobs.span, "_fence", lambda v: seen.append(v))
    tr = tobs.SpanTracer(capacity=4)
    with tr.span("step", axis="model", fence=lambda: out):
        out = torch.ones(8) * 2
    (s,) = tr.spans()
    assert s.name == "step" and s.t1 >= s.t0 and seen[0] is out
    rtr = robs.SpanTracer(capacity=4)
    with rtr.span("step", axis="model", fence=lambda: rout):
        rout = jnp.ones(8) * 2
    assert [x.name for x in rtr.spans()] == ["step"]


def test_tracer_is_deterministic_under_simclock():
    def run(obs, Clock, _):
        clock = Clock()
        tr = obs.SpanTracer(capacity=32, clock=clock.time)
        for i in range(5):
            with tr.span("tick", tick=i, axis="end_to_end"):
                clock.advance(0.01 * (i + 1))
        return [s.to_dict() for s in tr.spans()]

    want, got = both(run)
    assert got == want == both(run)[1]


def test_capacity_validation():
    for obs, _, _ in SIDES.values():
        with pytest.raises(ValueError, match="capacity"):
            obs.SpanTracer(capacity=0)


# ------------------------------------------------------------- export --

def _make_spans(obs, Clock):
    clock = Clock()
    tr = obs.SpanTracer(capacity=32, clock=clock.time)
    for tick, stream in enumerate(["cam0", "cam1"]):
        with tr.span("tick", stream=stream, tick=tick, axis="end_to_end", track=tick % 2):
            clock.advance(0.004)
            with tr.span("inference", stream=stream, tick=tick, rung="two_stage",
                         batch_size=2, axis="model"):
                clock.advance(0.002)
        tr.instant("rung_switch", stream=stream, axis="model")
    return tr.spans()


def test_chrome_trace_structure():
    want, got = both(lambda obs, Clock, _: obs.to_chrome_trace(_make_spans(obs, Clock),
                                                             process_label="test"))
    assert got == want
    assert tobs.validate_chrome_trace(got) == []
    evs = got["traceEvents"]
    assert {e["args"]["name"] for e in evs if e["ph"] == "M"} == {"test/cam0", "test/cam1"}
    assert len([e for e in evs if e["ph"] == "X"]) == 4
    assert len([e for e in evs if e["ph"] == "i"]) == 2


def test_chrome_trace_round_trips_through_disk(tmp_path):
    def run(obs, Clock, _):
        path = tmp_path / f"{obs.__name__}.json"
        doc = obs.write_chrome_trace(_make_spans(obs, Clock), str(path))
        return doc, path.read_text()

    (wdoc, wtext), (gdoc, gtext) = both(run)
    assert gtext == wtext
    assert json.loads(gtext) == json.loads(json.dumps(gdoc))
    assert tobs.validate_chrome_trace(json.loads(gtext)) == []


def test_validate_chrome_trace_catches_violations():
    bad = {"traceEvents": [
        {"ph": "X", "name": "a", "pid": 1, "tid": 0, "ts": -1.0, "dur": 2.0},
        {"ph": "??", "name": "b", "pid": 1, "tid": 0, "ts": 0.0},
        {"ph": "i", "name": "c", "pid": "one", "tid": 0, "ts": 0.0, "s": "x"},
        {"ph": "X", "name": "d"},
        "not-an-object",
    ]}
    for doc in ([], {}, bad):
        assert tobs.validate_chrome_trace(doc) == robs.validate_chrome_trace(doc)
    assert len(tobs.validate_chrome_trace(bad)) == 6


# ------------------------------------------------------------ sketches --

def test_p2_quantile_matches_on_one_series():
    rng = np.random.default_rng(0)
    xs = np.concatenate([[5.0, 1.0, 3.0], rng.uniform(0.0, 1.0, 4000), rng.exponential(2, 500)])
    for q in (0.5, 0.9, 0.99):
        p_r, p_t = robs.P2Quantile(q), tobs.P2Quantile(q)
        assert np.isnan(p_t.value()) and np.isnan(p_r.value())
        for i, x in enumerate(xs):
            p_r.update(x)
            p_t.update(x)
            if i in (2, 4, 100, len(xs) - 1):
                assert p_t.value() == pytest.approx(p_r.value(), **F64)
    for q in (0.0, 1.0, -0.1, 1.5):
        with pytest.raises(ValueError):
            tobs.P2Quantile(q)


def test_latency_sketch_quantiles_and_extremes():
    xs = np.random.default_rng(1).lognormal(-6.0, 0.8, 5000)
    sk_r, sk_t = robs.LatencySketch(), tobs.LatencySketch()
    sk_r.extend(xs)
    sk_t.extend(xs)
    assert sk_t.to_dict() == sk_r.to_dict()
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert sk_t.quantile(q) == pytest.approx(sk_r.quantile(q), **F64)
    assert sk_t.quantile(0.0) == xs.min() and sk_t.quantile(1.0) == xs.max()


def test_latency_sketch_merge_is_exact():
    rng = np.random.default_rng(2)
    a_xs, b_xs = rng.exponential(0.01, 800), rng.exponential(0.05, 1200)

    def run(obs, _, __):
        whole, a, b = obs.LatencySketch(), obs.LatencySketch(), obs.LatencySketch()
        whole.extend(np.concatenate([a_xs, b_xs]))
        a.extend(a_xs)
        b.extend(b_xs)
        merged = a.copy().merge(b)
        assert merged.to_dict() == whole.to_dict()
        return merged.to_dict(), merged.quantile(0.99)

    want, got = both(run)
    assert got == want


def test_latency_sketch_edges_underflow_and_nonfinite():
    def run(obs, _, __):
        with pytest.raises(ValueError, match="different edges"):
            obs.LatencySketch(gamma=1.02).merge(obs.LatencySketch(gamma=1.05))
        with pytest.raises(ValueError):
            obs.LatencySketch(lo=-1.0)
        sk = obs.LatencySketch(lo=1e-6)
        for x in (0.0, -3.0, float("nan"), 2e-3, float("inf")):
            sk.update(x)
        return sk.to_dict(), sk.quantile(0.5)

    want, got = both(run)
    assert got == want and got[0]["count"] == 3 and got[0]["dropped"] == 2


# ------------------------------------------------------------- metrics --

def _hub_sequence(obs):
    hub = obs.MetricsHub()
    rng = np.random.default_rng(3)
    lats = {("cam0", "two_stage"): rng.exponential(0.01, 400),
            ("cam0", "one_stage"): rng.exponential(0.002, 300),
            ("cam1", "two_stage"): rng.exponential(0.02, 500)}
    for (stream, rung), xs in lats.items():
        for i, x in enumerate(xs):
            hub.observe(stream, "inference", x, rung=rung, batch_size=i % 3)
    hub.observe("cam1", "inference", float("nan"), rung="one_stage")
    return hub


def test_metrics_hub_keys_and_summaries():
    want, got = _hub_sequence(robs), _hub_sequence(tobs)
    assert len(got) == len(want) == 10
    assert [tuple(vars(k).values()) for k in got.keys()] == \
        [tuple(vars(k).values()) for k in want.keys()]
    assert_close_tree(want.table(), got.table())
    key = tobs.MetricKey("cam0", "inference", "two_stage", 1)
    assert got.get(key).mean == pytest.approx(
        want.get(robs.MetricKey("cam0", "inference", "two_stage", 1)).mean, **F64)


def test_metrics_rollup_is_exact_merge():
    want, got = _hub_sequence(robs), _hub_sequence(tobs)
    for group in (lambda k: k.stream, lambda k: (k.stream, k.rung), lambda k: k.batch_size):
        rw, rg = want.rollup(group), got.rollup(group)
        assert list(rg) == list(rw)
        for g in rw:
            assert rg[g].sketch.to_dict() == rw[g].sketch.to_dict()
            assert_close_tree(rw[g].summary(), rg[g].summary())
            assert_close_tree(rw[g].welford.std, rg[g].welford.std)


def test_observe_span_keys_on_span_tags():
    def run(obs, _, __):
        hub = obs.MetricsHub()
        tr = obs.SpanTracer(capacity=8)
        hub.observe_span(tr.record("step", 0.0, 0.25, stream="tenant3", rung="r",
                                   batch_size=2, axis="model"))
        return hub.table()

    want, got = both(run)
    assert got == want and got[0]["count"] == 1


# ------------------------------------------------------------ adapters --

def test_timeline_recorder_forwards_to_hub():
    def run(obs, _, timing):
        hub = obs.MetricsHub()
        rec = timing.TimelineRecorder(metrics=hub, stream="cam0", rung="two_stage")
        for i in range(5):
            rec.add(timing.StageRecord(
                stages={"read": 0.001 * (i + 1), "inference": 0.004 + 1e-4 * i},
                meta={"batch_size": 4.0, "num_proposals": float(3 * i % 4)}))
        return (hub.table(), rec.summary("read").mean, rec.correlation_meta("num_proposals",
                                                                           "inference"),
                rec.dominant_stage(), rec.breakdown_table())

    want, got = both(run)
    assert_close_tree(want, got)
    assert {(r["stage"], r["batch_size"]) for r in got[0]} == {
        ("read", 4), ("inference", 4), ("end_to_end", 4)}


def test_stage_timer_forwards_spans_with_axis_tags():
    def run(obs, Clock, timing):
        clock = Clock()
        tr = obs.SpanTracer(capacity=16, clock=clock.time)
        timer = timing.StageTimer(clock=clock.time, tracer=tr,
                                  tags={"stream": "decode", "tick": 7, "batch_size": 3})
        for name, dt in (("read", 0.001), ("inference", 0.004), ("custom_stage", 0.002)):
            with timer.stage(name):
                clock.advance(dt)
        return timer.finish().stages, [s.to_dict() for s in tr.spans()]

    want, got = both(run)
    assert got == want
    assert [s["axis"] for s in got[1]] == ["io", "model", "end_to_end"]


def test_variance_decomposition_matches():
    from repro.core import variance as rvar
    from repro_torch.core import variance as tvar

    rng = np.random.default_rng(9)
    recs = []
    for pkg in (rtiming, ttiming):
        rec = pkg.TimelineRecorder()
        r = np.random.default_rng(9)
        for _ in range(60):
            inf = 0.004 + r.exponential(1e-3)
            rec.add(pkg.StageRecord(stages={"read": 1e-4 + r.exponential(1e-5), "inference": inf,
                                            "post_processing": 2 * inf + r.normal(0, 1e-4)},
                                    meta={"num_proposals": float(r.integers(0, 30))}))
        recs.append(rec)
    (rr, tr), _ = recs, rng
    assert_close_tree(rvar.decompose(rr).as_rows(), tvar.decompose(tr).as_rows())
    assert tvar.classify(tr) == rvar.classify(rr)
    assert tvar.explained_by_meta(tr, "num_proposals") == pytest.approx(
        rvar.explained_by_meta(rr, "num_proposals"), **F64)
    a, b = rng.exponential(1, 50), rng.exponential(2, 50)
    assert_close_tree(dict(rvar.variance_reduction(a, b)), dict(tvar.variance_reduction(a, b)))


def test_run_pipeline_and_instrument_record_every_stage():
    rec = ttiming.TimelineRecorder()
    outs = ttiming.run_pipeline([("pre", lambda x: x + 1), ("inference", lambda x: torch.ones(2) * x)],
                                iter(range(4)), rec, meta_fn=lambda v: {"n": float(v[0])})
    assert len(outs) == 4 and len(rec.records) == 3        # one warm-up job
    assert rec.stages() == ["pre", "inference"]
    assert list(rec.meta_series("n")) == [2.0, 3.0, 4.0]
    timer = ttiming.StageTimer()
    f = ttiming.instrument(lambda x: x * 2, "step", timer)
    assert float(f(torch.ones(1))) == 2.0 and f.__name__ == "timed_step"
    assert set(timer.finish().stages) == {"step"}


# --------------------------------------------------------- attribution --

def _frames(obs, rng, n, *, rung="r", contention=1.0, work=0, batch=4, base=0.010, noise=0.0):
    return [obs.FrameSample(latency_s=float(base * contention + (noise * rng.standard_normal()
                                                                 if noise else 0.0)),
                            stream="cam0", tick=i, segment="seg", scenario="city", rung=rung,
                            batch_size=batch, work=work, contention=contention)
            for i in range(n)]


@pytest.mark.parametrize("case", ["telescope", "model", "hardware", "mediated", "json"])
def test_attribution_matches(case):
    def run(obs, _, __):
        rng = np.random.default_rng(4)
        order = obs.attribution.ATTRIBUTION_ORDER
        if case == "telescope":
            frames = (_frames(obs, rng, 50, rung="a", noise=1e-3)
                      + _frames(obs, rng, 50, rung="b", base=0.02, noise=1e-3))
        elif case == "model":
            frames = (_frames(obs, rng, 60, rung="two_stage", base=0.013)
                      + _frames(obs, rng, 60, rung="one_stage", base=0.007))
        elif case == "hardware":
            frames = [f for lv in (1.0, 1.1, 1.2, 1.3) for f in _frames(obs, rng, 40,
                                                                        contention=lv)]
        elif case == "mediated":
            frames = (_frames(obs, rng, 80, rung="two_stage")
                      + _frames(obs, rng, 80, rung="one_stage", contention=1.3, base=0.006))
            order = MEDIATED_ORDER
        else:
            frames = _frames(obs, rng, 30, noise=1e-4, work=5)
        att = obs.attribute(frames, order=order)
        return att.to_dict(), att.table(), att.to_json()

    want, got = both(run)
    assert_close_tree(want[0], got[0])
    assert got[1] == want[1]
    shares = sum(e["share"] for e in got[0]["explained"].values())
    assert shares == pytest.approx(1.0, abs=1e-9)


def test_attribution_empty_and_errors():
    for obs, _, _ in SIDES.values():
        att = obs.attribute([])
        assert att.n == 0 and att.total_variance == 0.0 and att.explained == {}
        with pytest.raises(ValueError, match="no grouping feature"):
            obs.attribute([obs.FrameSample(latency_s=0.01)], order=("end_to_end",))
        with pytest.raises(ValueError, match="unknown axis"):
            att.share("gpu")


# ------------------------------------------------------------ dashboard --

def test_dashboard_renders_on_period():
    def run(obs, Clock, _):
        ob = obs.Observatory(clock=Clock().time)
        for i in range(12):
            ob.record("step", 0.0, 0.001 * (i + 1), stream="t0", axis="model")
        sink = io.StringIO()
        dash = ob.dashboard(period=5, sink=sink)
        rendered = [dash.step() for _ in range(12)]
        with pytest.raises(ValueError, match="period"):
            ob.dashboard(period=0)
        return rendered, dash.renders, sink.getvalue()

    want, got = both(run)
    assert got == want and got[1] == 2 and "spans:" in got[2]


def test_render_table_truncates_to_hottest_keys():
    def run(obs, _, __):
        hub = obs.MetricsHub()
        for i in range(20):
            hub.observe(f"s{i:02d}", "step", 0.001 * (1 + i % 3), batch_size=i)
        return obs.render_table(hub, top=4), obs.render_table(hub)

    want, got = both(run)
    assert got == want and "... 16 more keys" in got[0]


# ------------------------------------------------- the engine's tick spans --

@pytest.fixture(scope="module")
def engine_spans():
    """The same ticks through the reference's and the port's batched
    engines under a SimClock, with a deterministic stage cost, each with an
    observatory on the same virtual clock."""
    from repro.batched import BatchedPerceptionEngine as REngine
    from repro.perception import SceneConfig, build_pipeline, generate_scene
    from repro.perception.detector import OneStageDetector
    from repro_torch.batched import BatchedPerceptionEngine as TEngine

    params = {"early_exit": jax.tree.map(np.asarray, OneStageDetector().init(
        jax.random.PRNGKey(7)))}
    cost = lambda stage, batch, work: 1e-3 * (1 + len(stage)) * (1 + 0.1 * batch) + 1e-6 * work
    scenes = [generate_scene(SceneConfig("city", seed=2), t + 1).image for t in range(3)]
    out = {}
    for side, (obs, Clock, _) in SIDES.items():
        clock = Clock()
        ob = obs.Observatory(clock=clock.time)
        if side == "ref":
            eng = REngine(build_pipeline("early_exit"), capacity=2, clock=clock,
                          stage_cost=cost, obs=ob, obs_tag="cams")
        else:
            eng = TEngine("early_exit", capacity=2, clock=clock, stage_cost=cost, obs=ob,
                          obs_tag="cams", device="cpu", params=params)
        eng.join("a")
        eng.join("b")
        eng.tick({"a": scenes[0], "b": scenes[1]})
        eng.tick({"a": scenes[2]})
        eng.leave("b")
        eng.tick({"a": scenes[1]})
        out[side] = (ob, clock.time())
    return out


def test_engine_tick_spans_match(engine_spans):
    (rob, rt), (tob, tt) = engine_spans["ref"], engine_spans["port"]
    want = [s.to_dict() for s in rob.tracer.spans()]
    got = [s.to_dict() for s in tob.tracer.spans()]
    assert tt == pytest.approx(rt, **F64)
    assert [(s["name"], s["axis"], s["track"], s["parent"], s["seq"], s["tick"],
             s["batch_size"], s["stream"], s["rung"]) for s in got] == \
        [(s["name"], s["axis"], s["track"], s["parent"], s["seq"], s["tick"],
          s["batch_size"], s["stream"], s["rung"]) for s in want]
    for g, w in zip(got, want):
        assert g["t0"] == pytest.approx(w["t0"], **F64)
        assert g["t1"] == pytest.approx(w["t1"], **F64)
    assert [s["name"] for s in got[:4]] == ["tick", "read", "inference", "post_processing"]
    assert_close_tree(rob.metrics.table(), tob.metrics.table())
    assert tobs.validate_chrome_trace(tob.chrome_trace()) == []
