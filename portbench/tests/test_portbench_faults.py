"""A whole run on the CPU at a tiny size, past the harness's look for a card,
with the timed path broken underneath: ``correct`` has to come out false
for each fault a cell can have, and true for the sound run; and the
control, the reference in fp8 products put in the program's place, has to
fail the comparison."""
from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.kinds import infer, train
from portbench.reference.common import Numerics
from portbench.tools import calibrate

SEED = 2 ** 31 + 29
CPU = torch.device("cpu")


def _correct(root, name: str) -> tuple[bool, dict]:
    cell = harness.load_cell(name, root=root, bench_dir=root / "portbench")
    kind = infer if cell.kind == "infer" else train
    out = kind.run(cell, SEED, 0.3, False, CPU, 0.0)
    return harness.judge(out["readings"], cell.limits)


@pytest.mark.parametrize("name", ["ssm-tiny.infer-tiny", "ssm-tiny.train-tiny"])
def test_sound_run_is_correct(tiny_root, name):
    ok, checks = _correct(tiny_root, name)
    assert ok, checks


@pytest.mark.parametrize("fault", ["rows_swapped", "one_logit_raised"])
@pytest.mark.parametrize("name", ["ssm-tiny.infer-tiny"])
def test_an_answer_altered_where_produced_is_caught(tiny_root, monkeypatch, name, fault):
    from repro_torch.models import Model

    whole = Model.prefill

    def altered(self, params, batch):
        y = whole(self, params, batch)
        if fault == "rows_swapped":
            return y.flip(0)
        y = y.clone()
        y[0, 7] += 4.0 * y[0].float().std()
        return y

    monkeypatch.setattr(Model, "prefill", altered)
    ok, checks = _correct(tiny_root, name)
    assert not ok, checks


@pytest.mark.parametrize("name", ["ssm-tiny.train-tiny"])
def test_a_step_that_leaves_its_state_unchanged_is_caught(tiny_root, monkeypatch, name):
    import repro_torch.train.loop as loop

    def unchanged(cfg, params, grads, state, gnorm=None):
        return params, state, {"lr": torch.zeros(()), "grad_norm": torch.ones(())}

    monkeypatch.setattr(loop, "adamw_update", unchanged)
    ok, checks = _correct(tiny_root, name)
    assert not ok and checks["delta_gap"]["value"] == pytest.approx(1.0), checks


@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
@pytest.mark.parametrize("name", ["ssm-tiny.train-tiny"])
def test_a_planted_training_fault_is_caught(tiny_root, name, fault):
    """Half of the batch left out of the loss, or the scan's backward
    returning no gradient for the decay."""
    with calibrate.FAULTS[fault]():
        ok, checks = _correct(tiny_root, name)
    assert not ok, checks


@pytest.mark.parametrize("name", ["ssm-tiny.infer-tiny"])
def test_the_infer_control_fails(tiny_root, name):
    cell = harness.load_cell(name, root=tiny_root, bench_dir=tiny_root / "portbench")
    model, params, reqs = infer.prepare(cell, SEED, CPU)
    served = infer.serve(model, params, reqs, CPU, 0.2)
    idx = infer.sample(served.lengths, SEED, cell.traffic["check_requests"])
    refs = infer.reference_logits(cell, SEED, CPU, reqs, idx, Numerics())
    ctl = infer.reference_logits(cell, SEED, CPU, reqs, idx, Numerics(fp8=True))
    ok, checks = harness.judge(infer.readings(ctl, refs), cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("name", ["ssm-tiny.train-tiny"])
def test_the_train_control_fails(tiny_root, name):
    cell = harness.load_cell(name, root=tiny_root, bench_dir=tiny_root / "portbench")
    n = cell.traffic["checked_steps"]
    ref = train.reference(cell, SEED, CPU, n, Numerics())
    ctl = train.reference(cell, SEED, CPU, n, Numerics(fp8=True))
    ok, checks = harness.judge(train.readings(ctl, ref), cell.limits)
    assert not ok, checks
