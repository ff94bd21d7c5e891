"""The port's multi-tenant serving runtime (``repro_torch.runtime``) and
the pieces it stands on (deadline policies, the bus, the contention
simulator) against the JAX reference, on the CPU.

The engines run the smoke configurations in float32 on weights bridged
from the reference's ``init`` (``repro_torch.models.from_numpy``).  With
every request queued before ``drain`` and ``AlwaysAdmit``, the seating
order does not depend on measured latency, so per-tenant generated tokens,
ramp steps, slots, step counts and seating order must equal the
reference's exactly.  Admission decisions are held on one scripted
latency sequence; the seeded, pure-Python parts (Poisson workload, broker
and transport delays, deadline policies, contention curve) must give the
reference's values exactly.
"""
import dataclasses
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import bus as rbus  # noqa: E402
from repro import runtime as rrt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import deadline as rdl  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.runtime import admission as radm  # noqa: E402
from repro.sched import contention as rcont  # noqa: E402

from repro_torch import bus as tbus  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import deadline as tdl  # noqa: E402
from repro_torch.models import Model, from_numpy  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    AdmissionController,
    AlwaysAdmit,
    AnytimeAdmission,
    MultiTenantConfig,
    MultiTenantEngine,
    RequestQueue,
    StreamRequest,
    poisson_workload,
)
from repro_torch.runtime.admission import ADMIT, DEFER, SHED  # noqa: E402
from repro_torch.sched import contention_curve, contention_tasks  # noqa: E402

ARCHS = ("qwen3-4b", "rwkv6-3b")


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    """(jax model, jax params, port model, port params) at smoke size."""
    jcfg = jax_get_config(request.param, smoke=True)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, Model(get_config(request.param, smoke=True)), tparams


def make_engine(capacity=4, context=64, warmup=0, admission=None):
    """The reference test's engine: rwkv6-3b smoke cut to 2 layers and a
    64-token vocabulary, on the CPU."""
    model = Model(get_config("rwkv6-3b", smoke=True).replace(num_layers=2, vocab_size=64))
    params = model.init(seed=0, device="cpu")
    return MultiTenantEngine(
        model, params,
        MultiTenantConfig(capacity=capacity, context=context, warmup_steps=warmup),
        admission=admission, device="cpu")


def req(tenant, prompt, n=4, deadline=None, arrival=0.0, **kw):
    return StreamRequest(tenant=tenant, prompt=np.asarray(prompt, np.int32), max_new_tokens=n,
               deadline_s=deadline, arrival_s=arrival, **kw)


def _queued_run(engine, requests, queue_cls):
    q = queue_cls()
    for r in requests:
        q.push(r)
    engine.compile()
    steps = engine.drain(q)
    seated = [(t.req.tenant, t.slot, list(map(int, t.generated)), t.ramp_steps, t.jobs)
              for t in engine.finished]
    return steps, seated


# ------------------------------------------------------ engine parity ------
@pytest.mark.parametrize("capacity,n_streams,prompt_len,new", [(3, 7, 4, 5), (2, 4, 1, 3),
                                                                (4, 4, 6, 2)])
def test_queued_workload_generates_the_reference_s_tokens(bridged, capacity, n_streams,
                                                          prompt_len, new):
    jmodel, jparams, tmodel, tparams = bridged
    work = dict(rate_hz=100.0, vocab_size=tmodel.cfg.vocab_size, prompt_len=prompt_len,
                max_new_tokens=new, seed=capacity)
    ref = rrt.MultiTenantEngine(jmodel, jparams, rrt.MultiTenantConfig(capacity, 32),
                                admission=rrt.AlwaysAdmit())
    port = MultiTenantEngine(tmodel, tparams, MultiTenantConfig(capacity, 32),
                             admission=AlwaysAdmit(), device="cpu")
    before = kernels.launch_counts()
    want = _queued_run(ref, rrt.poisson_workload(n_streams, **work), rrt.RequestQueue)
    got = _queued_run(port, poisson_workload(n_streams, **work), RequestQueue)
    assert got == want
    assert port.steps == ref.steps and len(port.step_log) == len(ref.step_log)
    assert [n for n, _ in port.step_log] == [n for n, _ in ref.step_log]
    assert port.trace_count == ref.trace_count == 1
    assert kernels.launch_counts() == before          # CPU tensors never launch
    rows, want_rows = port.per_tenant_report(), ref.per_tenant_report()
    assert [set(r) for r in rows] == [set(r) for r in want_rows]
    for a, b in zip(rows, want_rows):
        for k in ("tenant", "status", "jobs", "ramp_steps", "tokens"):
            assert a[k] == b[k]
    assert set(port.aggregate_report()) == set(ref.aggregate_report())


def test_zero_slot_carves_out_one_slot_only(bridged):
    """Every state leaf's slot is zeroed along axis 1; the other slots and
    the shared KV bookkeeping (positions, next_pos) are untouched."""
    _, _, tmodel, tparams = bridged
    eng = MultiTenantEngine(tmodel, tparams, MultiTenantConfig(3, 16), device="cpu")
    for t in range(3):
        eng.join(req(f"t{t}", [1 + t, 2, 3], n=4))
    for _ in range(3):
        eng.step()
    st = eng._state
    leaves = ([st.kv.k, st.kv.v] if st.kv is not None else []) + \
        (list(st.rwkv) if st.rwkv is not None else [])
    before = [x.clone() for x in leaves]
    pos = (st.kv.positions.clone(), st.kv.next_pos.clone()) if st.kv is not None else None
    eng._zero_slot(st, 1)
    for x, b in zip(leaves, before):
        assert torch.count_nonzero(b[:, 1]) > 0
        assert torch.count_nonzero(x[:, 1]) == 0
        assert torch.equal(x[:, 0], b[:, 0]) and torch.equal(x[:, 2], b[:, 2])
    if pos is not None:
        assert torch.equal(st.kv.positions, pos[0]) and torch.equal(st.kv.next_pos, pos[1])


def test_slot_carveout_isolates_tenants():
    """A slot's recurrent state is reset on join: a stream generates the
    same tokens whether it follows another tenant in the slot or runs in a
    fresh engine (exact for recurrent-state families)."""
    prompt = [7, 11, 13]
    eng = make_engine(capacity=1)
    eng.join(req("first", [3, 5, 2, 9], n=8))
    while eng.active:
        eng.step()
    eng.join(req("second", prompt, n=8))
    while eng.active:
        eng.step()
    reused = next(t for t in eng.finished if t.req.tenant == "second").generated
    fresh_eng = make_engine(capacity=1)
    fresh_eng.join(req("second", prompt, n=8))
    while fresh_eng.active:
        fresh_eng.step()
    assert reused == fresh_eng.finished[0].generated


def test_join_leave_keeps_the_one_build():
    eng = make_engine(capacity=3)
    eng.compile()
    assert eng.trace_count == 1
    eng.join(req("a", [1, 2], n=6))
    for _ in range(3):
        eng.step()
    eng.join(req("b", [3], n=2))
    while eng.active:
        eng.step()
    eng.join(req("c", [5, 6, 7], n=3))
    while eng.active:
        eng.step()
    assert eng.trace_count == 1
    assert len(eng.finished) == 3
    assert all(len(t.generated) == t.req.max_new_tokens for t in eng.finished)


def test_compile_leaves_the_live_state_untouched():
    eng = make_engine(capacity=2)
    zeros = [x.clone() for x in eng._state.rwkv]
    eng.compile()
    eng.compile()
    assert eng.trace_count == 1
    assert all(torch.equal(a, b) for a, b in zip(eng._state.rwkv, zeros))


def test_free_slots_are_fifo_and_a_full_batch_raises():
    eng = make_engine(capacity=3)
    a = eng.join(req("a", [1], n=2))
    b = eng.join(req("b", [2], n=2))
    assert (a.slot, b.slot) == (0, 1)
    eng.leave(a.slot)
    c = eng.join(req("c", [3], n=2))
    d = eng.join(req("d", [4], n=2))
    assert (c.slot, d.slot) == (2, 0)
    with pytest.raises(RuntimeError, match="no free slot"):
        eng.join(req("e", [5], n=2))


def test_per_tenant_miss_accounting_and_ramp_scoring():
    eng = make_engine(capacity=2)
    eng.compile()
    eng.join(req("tight", [1, 2], n=5, deadline=1e-12))
    eng.join(req("loose", [3, 4], n=5, deadline=1e6))
    while eng.active:
        eng.step()
    rows = {r["tenant"]: r for r in eng.per_tenant_report()}
    assert rows["tight"]["jobs"] == rows["loose"]["jobs"] == 4
    assert rows["tight"]["misses"] == 4 and rows["loose"]["misses"] == 0
    t = next(x for x in eng.finished if x.req.tenant == "tight")
    assert set(t.recorder.meta_series("n_active")) == {2.0}
    assert t.recorder.stages() == ["read", "inference", "post_processing"]

    eng = make_engine(capacity=1)
    eng.join(req("a", [1, 2, 3, 4], n=6))
    steps = 0
    while eng.active:
        eng.step()
        steps += 1
    ts = eng.finished[0]
    assert (steps, ts.ramp_steps, ts.jobs, len(ts.generated)) == (9, 4, 5, 6)
    assert ts.policy._w.n == steps


def test_drain_with_sim_clock_and_source_rules():
    eng = make_engine(capacity=2)
    q = RequestQueue()
    for r in poisson_workload(5, rate_hz=1000.0, vocab_size=64, prompt_len=3,
                              max_new_tokens=4, seed=0):
        q.push(r)
    clock = tbus.SimClock()
    steps = eng.drain(q, clock=clock)
    assert steps == eng.steps > 0
    assert clock.time() == pytest.approx(sum(lat for _, lat in eng.step_log), rel=1e-9)
    agg = eng.aggregate_report()
    assert agg["streams"] == 5 and agg["traces"] == 1 and math.isfinite(agg["step_mean_s"])

    class FakeSource:
        def deliver_until(self, t):
            return 0

        def next_delivery(self):
            return None

    with pytest.raises(ValueError, match="needs a clock"):
        make_engine(capacity=1).drain(RequestQueue(), source=FakeSource())


def test_engine_sheds_under_synthetic_overload():
    eng = make_engine(capacity=2, admission=AdmissionController())
    eng.compile()
    probe = RequestQueue()
    probe.push(req("probe", [1, 2], n=6))
    eng.drain(probe)
    queue = RequestQueue()
    for i in range(4):
        queue.push(req(f"tight-{i}", [i + 1], n=4, deadline=1e-12))
    for i in range(4):
        queue.push(req(f"loose-{i}", [i + 1], n=4, deadline=1e6))
    eng.drain(queue)
    rows = {r["tenant"]: r for r in eng.per_tenant_report()}
    assert len(eng.shed) == 4
    assert all(rows[f"tight-{i}"]["status"] == "shed" for i in range(4))
    assert all(rows[f"loose-{i}"]["status"] == "finished" and rows[f"loose-{i}"]["misses"] == 0
               for i in range(4))


def test_engine_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(get_config("rwkv6-3b", smoke=True).replace(num_layers=1, vocab_size=64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiTenantEngine(model, {}, MultiTenantConfig(1, 8))


# ------------------------------------------------------ admission ----------
# occupancy → step latency, then requests decided one after another; the
# same script drives both packages' controllers
LATENCIES = [(1, 0.010), (1, 0.0101), (2, 0.020), (2, 0.0201), (3, 0.030), (3, 0.0301),
             (2, 0.0195), (4, 0.041)]
DECISIONS = [  # (tenant, deadline, degrade factors, arrival, n_active, now)
    ("be", None, (), 0.0, 3, 0.0), ("ok", 0.05, (), 0.0, 1, 0.0),
    ("mid", 0.015, (), 0.0, 2, 0.0), ("mid", 0.015, (), 0.0, 2, 0.1),
    ("impossible", 0.001, (), 0.0, 0, 0.0), ("rescued", 0.008, (1.5, 2.5), 0.0, 0, 0.0),
    ("deferred", 0.012, (2.0,), 0.0, 3, 0.0), ("old", 0.015, (), 0.0, 2, 2.0),
    ("tight", 0.025, (1.2,), 0.0, 2, 0.0), ("none", 0.0001, (1.5,), 0.0, 1, 0.0),
]


def _decide_all(mod, ctrl):
    out = []
    reqs = {}
    for tenant, deadline, degrade, arrival, n_active, now in DECISIONS:
        # the same request object is re-decided when it reappears (a
        # head-of-line retry), as the engine does
        key = (tenant, deadline)
        if key not in reqs:
            reqs[key] = mod.StreamRequest(tenant=tenant, prompt=np.ones(2, np.int32),
                                          max_new_tokens=2, deadline_s=deadline,
                                          arrival_s=arrival, degrade_factors=degrade)
        d = ctrl.decide(reqs[key], n_active, now)
        granted = d.request.deadline_s if d.request is not None else None
        pred = None if d.predicted is None else (d.predicted.mean, d.predicted.std)
        out.append((d.action, d.reason, granted, pred))
    return out, (ctrl.admitted, ctrl.deferred, ctrl.shed)


@pytest.mark.parametrize("kind", ["controller", "anytime", "always"])
@pytest.mark.parametrize("confidence,max_wait", [(0.9, math.inf), (0.95, 0.5)])
def test_admission_decisions_equal_the_reference_s(kind, confidence, max_wait):
    def build(adm_mod):
        if kind == "always":
            return adm_mod.AlwaysAdmit()
        ctrl = adm_mod.AdmissionController(confidence=confidence, max_wait_s=max_wait)
        for occ, lat in LATENCIES:
            ctrl.observe_step(occ, lat)
        return adm_mod.AnytimeAdmission(ctrl) if kind == "anytime" else ctrl

    import repro_torch.runtime as trt
    from repro_torch.runtime import admission as tadm
    got = _decide_all(trt, build(tadm))
    want = _decide_all(rrt, build(radm))
    assert got == want
    actions = {a for a, *_ in got[0]}
    if kind != "always":
        assert actions == {ADMIT, DEFER, SHED}


def test_anytime_admission_counts_degraded_streams():
    ctrl = AdmissionController(confidence=0.9)
    for occ, lat in LATENCIES:
        ctrl.observe_step(occ, lat)
    any_ = AnytimeAdmission(ctrl)
    d = any_.decide(req("r", [1], deadline=0.008, degrade_factors=(1.5, 2.5)), 0, 0.0)
    # x1.5 (12 ms) is still below the predicted solo tail; x2.5 fits
    assert d.action == ADMIT and d.request.deadline_s == pytest.approx(0.020)
    assert any_.degraded == 1 and any_.degrade_log == [("r", 2.5)]
    assert (any_.admitted, any_.shed) == (1, 0)


def test_cold_start_admits_then_learns():
    ctrl = AdmissionController(min_observations=3)
    assert ctrl.decide(req("a", [1], deadline=1e-9), 0, 0.0).action == ADMIT
    for _ in range(3):
        ctrl.observe_step(1, 0.01)
    assert ctrl.decide(req("b", [1], deadline=1e-9), 0, 0.0).action == SHED


# ------------------------------------------- seeded pure-Python pieces -----
def test_poisson_workload_equals_the_reference_s():
    for seed in (0, 3):
        got = poisson_workload(16, rate_hz=50.0, vocab_size=64, prompt_len=5, max_new_tokens=7,
                               deadline_s=0.02, seed=seed, degrade_factors=(1.5,))
        want = rrt.poisson_workload(16, rate_hz=50.0, vocab_size=64, prompt_len=5,
                                    max_new_tokens=7, deadline_s=0.02, seed=seed,
                                    degrade_factors=(1.5,))
        for a, b in zip(got, want):
            assert (a.tenant, a.arrival_s, a.max_new_tokens, a.deadline_s, a.degrade_factors) == \
                (b.tenant, b.arrival_s, b.max_new_tokens, b.deadline_s, b.degrade_factors)
            np.testing.assert_array_equal(a.prompt, b.prompt)
        assert [r.arrival_s for r in got] == sorted(r.arrival_s for r in got)


def test_stream_request_and_queue_rules():
    with pytest.raises(ValueError, match="at least one token"):
        req("t", [])
    with pytest.raises(ValueError, match="max_new_tokens"):
        req("t", [1, 2], n=0)
    with pytest.raises(ValueError, match="degrade_factors"):
        req("t", [1], degrade_factors=(0.5,))
    q = RequestQueue()
    a, b = req("a", [1]), req("b", [2])
    q.push(a)
    q.push(b)
    first = q.pop()
    q.requeue(first)
    assert q.pop() is a and q.pop() is b and not q and q.pushed == 2
    assert dataclasses.replace(a, deadline_s=1.0).admission_token == a.admission_token
    with pytest.raises(ValueError, match="capacity"):
        MultiTenantConfig(capacity=0, context=64)


@pytest.mark.parametrize("size", [62 * 1024, int(6.2 * 1024 * 1024), 100])
@pytest.mark.parametrize("subs", [1, 4, 8])
def test_transport_delays_equal_the_reference_s(size, subs):
    for tcls, rcls in ((tbus.CopyTransport, rbus.CopyTransport),
                       (tbus.DatagramTransport, rbus.DatagramTransport)):
        got = tbus.publish_latencies(tcls(), tbus.Message("m", size), subs, n_messages=20, seed=4)
        want = rbus.publish_latencies(rcls(), rbus.Message("m", size), subs, n_messages=20,
                                      seed=4)
        np.testing.assert_array_equal(got, want)


def test_broker_delivers_as_the_reference_s():
    def run(mod):
        b = mod.Broker(transport=mod.DatagramTransport(), seed=3)
        got = []
        sub = b.subscribe("img", callback=lambda e: got.append((e.seq, e.delivered_at)),
                          queue_size=2)
        b.subscribe("img", queue_size=1)
        for i in range(6):
            b.publish("img", None, 62 * 1024, now=0.001 * i)
        b.deliver_until(0.0035)
        nxt = b.next_delivery()
        b.deliver_until(1.0)
        return got, sub.dropped, nxt, dict(b.delays)

    assert run(tbus) == run(rbus)
    with pytest.raises(ValueError, match="queue_size=0"):
        tbus.Broker().subscribe("x", queue_size=0)


def test_deadline_policies_and_evaluate_equal_the_reference_s():
    trace = np.random.default_rng(2).lognormal(np.log(0.01), 0.3, 300)
    names = [p.name for p in tdl.POLICIES()]
    assert names == [p.name for p in rdl.POLICIES()]
    for got_p, want_p in zip(tdl.POLICIES(), rdl.POLICIES()):
        assert tdl.evaluate(got_p, trace, warmup=8).as_row() == \
            rdl.evaluate(want_p, trace, warmup=8).as_row()
    a, b = tdl.DynamicDeadline(alpha=0.2, headroom=1.3), rdl.DynamicDeadline(alpha=0.2,
                                                                          headroom=1.3)
    assert a.deadline() == b.deadline() == math.inf
    for i, x in enumerate(trace[:40]):
        if i == 20:
            a.set_criticality(0.7)
            b.set_criticality(0.7)
        a.observe(x)
        b.observe(x)
        assert a.deadline() == b.deadline()
    rep = tdl.evaluate(tdl.MeanDeadline(), [0.01] * 4, warmup=8)
    assert math.isnan(rep.miss_rate) and rep.as_row()["policy"] == "mean"


def test_dynamic_deadline_tenants_get_their_criticality():
    eng = MultiTenantEngine(Model(get_config("rwkv6-3b", smoke=True).replace(
        num_layers=1, vocab_size=64)), Model(get_config("rwkv6-3b", smoke=True).replace(
            num_layers=1, vocab_size=64)).init(seed=0, device="cpu"),
        MultiTenantConfig(2, 8), policy_factory=lambda r: tdl.DynamicDeadline(), device="cpu")
    ts = eng.join(req("c", [1, 2], n=2, criticality=0.5))
    assert ts.policy._criticality == 0.5


def test_contention_curve_equals_the_reference_s():
    got = contention_curve((1, 2, 4), seed=3, n_jobs=40)
    want = rcont.contention_curve((1, 2, 4), seed=3, n_jobs=40)
    assert got == want
    assert got[-1]["p99_s"] > got[0]["p99_s"]
    assert [t.name for t in contention_tasks(3)] == [t.name for t in rcont.contention_tasks(3)]


# ------------------------------------------------------------ the CLIs -----
def test_streams_cli_with_obs_and_anytime_runs_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import serve
    trace = tmp_path / "serve_trace.json"
    serve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu", "--streams", "6",
                "--batch", "3", "--context", "16", "--prompt-len", "3", "--tokens", "4",
                "--slo-ms", "0.001", "--anytime", "--obs", "--obs-period", "5",
                "--trace-out", str(trace)])
    captured = capsys.readouterr()
    out = captured.out
    # every tenant is served or shed (measured latencies decide which)
    served, shed = re.search(r"served (\d+) streams \((\d+) shed", out).groups()
    assert int(served) + int(shed) == 6 and "traces=1" in out
    assert "tenant-05" in out and "obs dashboard" in captured.err and trace.exists()


@pytest.mark.parametrize("arch", ARCHS)
def test_streams_cli_runs_on_the_cpu(capsys, arch):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--streams", "5", "--batch", "2",
                "--context", "16", "--prompt-len", "2", "--tokens", "3", "--admission", "none"])
    out = capsys.readouterr().out
    assert "served 5 streams (0 shed, 0 degraded)" in out and "traces=1" in out


def test_fleet_cli_runs_on_the_cpu(capsys, tmp_path):
    import json

    from repro_torch.launch import serve
    path = tmp_path / "fleet.json"
    serve.main(["--fleet", "--streams", "3", "--ticks", "4", "--device", "cpu",
                "--json-out", str(path)])
    doc = json.loads(path.read_text())
    assert doc["frames"] == 12 and doc["n_shards"] == 1 and doc["mesh"] is None
    assert all(n <= 1 for n in doc["trace_counts"].values())
    assert "fleet: 3 streams x 4 ticks" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--fleet", "--streams", "2", "--mesh", "data=2"], "step 8"),
    (["--fleet", "--streams", "2", "--chaos", "sensor_stall_storm"], "step 7"),
    (["--arch", "rwkv6-3b", "--streams", "2", "--anytime"], "--slo-ms"),
    (["--arch", "rwkv6-3b", "--streams", "2", "--anytime", "--slo-ms", "1",
      "--admission", "none"], "predictive"),
    (["--arch", "rwkv6-3b", "--degrade-factors", "2"], "without --anytime"),
    (["--arch", "rwkv6-3b", "--obs"], "--obs needs"),
    (["--arch", "rwkv6-3b", "--trace-out", "x.json"], "without --obs"),
    (["--fleet"], "--streams"),
    (["--fleet", "--streams", "2", "--arch", "rwkv6-3b"], "drop --arch"),
    (["--arch", "rwkv6-3b", "--json-out", "x.json"], "only applies to --fleet"),
    ([], "--arch is required"),
])
def test_serve_cli_validations(capsys, argv, match):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(argv + ["--device", "cpu"])
    assert match in capsys.readouterr().err
