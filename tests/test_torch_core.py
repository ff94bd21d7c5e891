"""The port's core (latency stats, stage timing, deadline policies) against
the reference's ``repro.core`` on the same latency traces.  Pure host
float64 math on both sides, so results must be equal to 1e-12."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import deadline as jd  # noqa: E402
from repro.core import stats as js  # noqa: E402
from repro.core.timing import StageRecord as JaxStageRecord  # noqa: E402
from repro.core.timing import TimelineRecorder as JaxTimelineRecorder  # noqa: E402

from repro_torch.core import deadline as td  # noqa: E402
from repro_torch.core import stats as ts  # noqa: E402
from repro_torch.core.timing import StageRecord, StageTimer, TimelineRecorder, fence, \
    timed_stage  # noqa: E402

TRACE = np.random.default_rng(0).gamma(4.0, 0.005, 200)


def test_summaries_match_reference():
    assert ts.summarize(TRACE).as_row() == js.summarize(TRACE).as_row()
    for fn in ("latency_range", "coefficient_of_variation", "tail_ratio"):
        assert getattr(ts, fn)(TRACE) == getattr(js, fn)(TRACE)
    w_t, w_j = ts.Welford(), js.Welford()
    w_t.update_many(TRACE)
    w_j.update_many(TRACE)
    assert (w_t.mean, w_t.std, w_t.range) == (w_j.mean, w_j.std, w_j.range)


@pytest.mark.parametrize("make", [
    lambda m: m.WorstObserved(),
    lambda m: m.MeanDeadline(margin=1.5),
    lambda m: m.PercentileDeadline(q=95.0),
    lambda m: m.KalmanDeadline(),
])
def test_deadline_policies_match_reference(make):
    pt, pj = make(td), make(jd)
    assert pt.name == pj.name and pt.deadline() == pj.deadline()
    for x in TRACE:
        pt.observe(x)
        pj.observe(x)
        np.testing.assert_allclose(pt.deadline(), pj.deadline(), rtol=1e-12)
    pt.reset()
    assert pt.deadline() == make(td).deadline()


def test_recorder_breakdown_matches_reference():
    rt, rj = TimelineRecorder(), JaxTimelineRecorder()
    rng = np.random.default_rng(1)
    for _ in range(50):
        stages = {"read": rng.random() * 1e-3, "inference": rng.random() * 1e-2,
                  "post_processing": rng.random() * 1e-3}
        rt.add(StageRecord(stages=dict(stages)))
        rj.add(JaxStageRecord(stages=dict(stages)))
    for a, b in zip(rt.breakdown_table(), rj.breakdown_table()):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-12)
    assert rt.summary().as_row() == rj.summary().as_row()


def test_stage_timer_and_cpu_fence():
    ticks = iter([0.0, 1.0, 1.0, 3.5, 3.5, 4.0])
    timer = StageTimer(clock=lambda: next(ticks))
    with timer.stage("read"):
        pass
    x = torch.ones(3)
    with timed_stage(timer, "inference", x, {"y": [x]}):
        pass
    with timer.stage("read"):
        pass
    timer.note("n", 2)
    rec = timer.finish()
    assert rec.stages == {"read": 1.5, "inference": 2.5} and rec.meta == {"n": 2.0}
    assert rec.end_to_end == 4.0 and timer.finish().stages == {}
    fence(x, (x,), {"a": x})   # CPU tensors: nothing to wait for
