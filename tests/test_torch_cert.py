"""The port's static timing certifier (``repro_torch.analysis.cert``)
against the reference's (``repro.analysis.cert``) on the CPU.

Shared with the reference: ``CERT_SHAPES``, the envelope's description
and hash.  The counter: the closed forms of products and convolutions,
pointwise/transcendental/reduction counts, a host sync and an in-place
write inside a program, the floor as the max of its terms.  Against the
reference's committed ``analysis/certificate.json``: every ``*/step`` (one
shard) and ``ladder/*/infer`` program's convolution plus matrix-product
flops equal its ``conv_general_dilated + dot_general`` exactly, the step
signatures equal, the port's floors under the reference's CPU model
within 10 % of the reference's floors; the attention kernels' declared
products equal the reference's ``dot_general`` at ``CERT_SHAPES`` (the
scans' follow the CUDA kernels' tiles: their ratios are stated).  The
certificate's behaviour: a small envelope certifies with no recapture, a
copy of the engine with a shape-dependent branch flips the gate, a 2×
prior perturbation fires the drift gate, signature drift is fatal and
count drift a note, a missing certificate is a usage error, and the
committed ``analysis/torch_certificate.json`` checks clean and carries
the card's measurements.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.analysis.cert import default_envelope as jax_default_envelope  # noqa: E402
from repro.analysis.cert import envelope_hash as jax_envelope_hash  # noqa: E402
from repro.kernels import CERT_SHAPES as JAX_CERT_SHAPES  # noqa: E402

from repro_torch.analysis.cert import (CPU_2CORE, H100_SXM, InputEnvelope,  # noqa: E402
                                       RungPoint, aval_signature, build_static, certify_rung,
                                       check, count_program, default_envelope, drift_findings,
                                       envelope_hash, intrinsic_findings, roofline_floor)
from repro_torch.analysis.cert.__main__ import main as cert_main  # noqa: E402
from repro_torch.analysis.cert.tracer import trace_kernel  # noqa: E402
from repro_torch.kernels import CERT_SHAPES  # noqa: E402
from repro_torch.perception.data import H, W  # noqa: E402

REPO = Path(__file__).parent.parent
REF_CERT = REPO / "analysis" / "certificate.json"
TORCH_CERT = REPO / "analysis" / "torch_certificate.json"
MATMUL = ("mm", "bmm", "addmm", "baddbmm", "mv", "dot", "convolution")
# the port's floors under the reference's CPU model, against the
# reference's committed floors (flops-bound there: the counts of the
# pointwise and reduction ops differ by how each library splits them)
FLOOR_BAND = 0.10
# the scans' declared products over the reference's dot_general at
# CERT_SHAPES: the CUDA kernels' tiles (WKV fold tiles of 32 rows with
# 16-row sub-blocks, SSD sub-tiles of 64) against the Pallas folds
SCAN_RATIOS = {"rwkv6_wkv": 0.5625, "mamba2_ssd": 1703936 / 1736704}


def _small_env(**kw) -> InputEnvelope:
    """A fast envelope: one rung, capacity 2, no ladder/kernels."""
    defaults = dict(capacity=2, occupancies=(1, 2), batch_sizes=(1,), image_shape=(H, W, 3),
                    rungs=(RungPoint("early_exit", "early_exit"),), ladder_rungs=(),
                    kernels=(), churn=True, fleet_shards=(1,))
    defaults.update(kw)
    return InputEnvelope(**defaults)


@pytest.fixture(scope="module")
def ref_cert():
    return json.loads(REF_CERT.read_text())


@pytest.fixture(scope="module")
def static():
    return build_static()


def _conv_mm(by_prim: dict) -> float:
    return sum(by_prim.get(k, 0.0) for k in MATMUL)


# ----------------------------------------------- shared with the reference --

def test_cert_shapes_are_the_reference_s():
    assert CERT_SHAPES == JAX_CERT_SHAPES


def test_envelope_describes_and_hashes_as_the_reference_s():
    env, ref = default_envelope(), jax_default_envelope()
    assert json.dumps(env.describe(), sort_keys=True) == json.dumps(ref.describe(),
                                                                    sort_keys=True)
    assert envelope_hash(env) == jax_envelope_hash(ref) == "edd842b827d07805"


def test_envelope_hash_pins_the_input_set():
    assert envelope_hash(_small_env()) != envelope_hash(_small_env(batch_sizes=(1, 2)))
    assert envelope_hash(_small_env()) == envelope_hash(_small_env())


# ------------------------------------------------------------- counting --

def test_matmul_and_conv_closed_forms():
    c, _ = count_program(lambda a, b: a @ b, torch.empty(3, 5), torch.empty(5, 7))
    assert c.by_prim == {"mm": 2.0 * 3 * 7 * 5}
    c, _ = count_program(lambda a, b: torch.bmm(a, b), torch.empty(2, 3, 5),
                         torch.empty(2, 5, 4))
    assert c.by_prim == {"bmm": 2.0 * 2 * 3 * 4 * 5}
    x, w = torch.empty(2, 6, 10, 12), torch.empty(8, 3, 3, 3)
    c, out = count_program(lambda x, w: torch.nn.functional.conv2d(x, w, groups=2,
                                                                   padding=1), x, w)
    assert tuple(out.shape) == (2, 8, 10, 12)
    assert c.by_prim == {"convolution": 2.0 * 2 * 8 * 10 * 12 * 3 * 3 * 3}


def test_reduce_and_transcendental_counts():
    c, _ = count_program(lambda x: torch.exp(x).sum(-1) + 1.0, torch.empty(4, 6))
    assert c.by_prim == {"exp": 24.0, "sum": 24.0, "add": 4.0}
    assert c.transcendentals == 24.0 and c.flops == 52.0


def test_views_and_copies_move_bytes_only():
    c, _ = count_program(lambda x: x.t().contiguous().reshape(-1), torch.empty(4, 6))
    assert c.flops == 0.0 and c.mem_bytes == 2 * 24 * 4
    assert c.write_bytes == 0.0


def test_host_sync_inside_a_program_is_recorded():
    def prog(x):
        n = x.sum().item()                      # a host sync
        return x * 2, n

    c, _ = count_program(prog, torch.empty(3))
    assert [p[1] for p in c.host_prims] == ["aten._local_scalar_dense"]
    assert c.host_prims[0][0] == "<program>"
    c, out = count_program(lambda x: torch.nonzero(x > 0), torch.empty(5, 2))
    assert "aten.nonzero" in [p[1] for p in c.host_prims]
    assert tuple(out.shape) == (10, 2)          # the largest output stands in


def test_in_place_write_to_an_input_is_visible():
    def prog(a, b):
        a.add_(1.0)
        return b * 2

    c, _ = count_program(prog, torch.empty(3), torch.empty(3))
    assert c.mutated == [True, False]
    c, _ = count_program(lambda a: a[1:].zero_(), torch.empty(3))
    assert c.mutated == [True]                   # through a view


def test_intrinsic_findings_flag_a_mutation_mismatch():
    ok = {"programs": {"x/step": {"declared_mutation": [], "mutated_inputs": [False]}}}
    bad = {"programs": {"x/step": {"declared_mutation": [], "mutated_inputs": [True]}}}
    assert intrinsic_findings(ok) == []
    found = intrinsic_findings(bad)
    assert len(found) == 1 and found[0].startswith("MUTATION x/step")


def test_roofline_floor_is_the_max_of_its_terms():
    assert roofline_floor(9.6e10, 0.0, 0.0, CPU_2CORE) == pytest.approx(1.0)
    assert roofline_floor(0.0, 6e10, 3e10, CPU_2CORE) == pytest.approx(2.0)
    assert roofline_floor(0.0, 0.0, 6.4e10, H100_SXM) == pytest.approx(1.0)
    assert roofline_floor(495e12, 1.0, 1.0, H100_SXM, "tf32") == pytest.approx(1.0)
    assert roofline_floor(989e12, 1.0, 1.0, H100_SXM) == pytest.approx(1.0)


def test_signature_format():
    sig = aval_signature((torch.zeros(2, 3), torch.zeros((), dtype=torch.int32)))
    assert sig == "(f32[2,3], i32[])"


# ------------------------------------- against the reference's certificate --

def test_steps_and_ladder_products_equal_the_reference_s(static, ref_cert):
    both = [n for n in ref_cert["programs"] if n in static["programs"]]
    steps = [n for n in both if n.endswith("/step")]
    ladder = [n for n in both if n.startswith("ladder/")]
    assert len(steps) == 3 and len(ladder) == 5
    for name in steps + ladder:
        ref = ref_cert["programs"][name]["by_prim"]
        want = ref.get("conv_general_dilated", 0.0) + ref.get("dot_general", 0.0)
        assert _conv_mm(static["programs"][name]["by_prim"]) == want, name
    assert _conv_mm(static["programs"]["two_stage/step"]["by_prim"]) == 141_557_760.0
    for name in steps:
        assert static["programs"][name]["signatures"] == \
            ref_cert["programs"][name]["signatures"] == ["(f32[8,96,320,3])"]


def test_cpu_model_floors_within_the_band_of_the_reference_s(static, ref_cert):
    ref = {(r["rung"], r["batch_size"]): r["floor_s"] for r in ref_cert["cost_table"]}
    assert len(static["cost_table"]) == len(ref) == 12
    for row in static["cost_table"]:
        floor = roofline_floor(row["flops"], row["bytes_min"], row["h2d_bytes"], CPU_2CORE)
        want = ref[(row["rung"], row["batch_size"])]
        assert abs(floor / want - 1.0) <= FLOOR_BAND, (row["rung"], row["batch_size"])


def test_kernels_declared_products_against_the_reference_s(ref_cert):
    env = default_envelope()
    for kp in env.kernels:
        got = trace_kernel(kp).counts.by_prim[f"kernel_matmul:{kp.name}"]
        want = ref_cert["programs"][f"kernels/{kp.name}"]["by_prim"]["dot_general"]
        if kp.name in SCAN_RATIOS:
            assert got / want == pytest.approx(SCAN_RATIOS[kp.name], rel=1e-12), kp.name
        else:
            assert got == want, kp.name
    ref = ref_cert["programs"]
    for kp in env.kernels:
        summ = trace_kernel(kp)
        assert summ.signatures == ref[f"kernels/{kp.name}"]["signatures"]
        assert (summ.in_bytes, summ.out_bytes) == (ref[f"kernels/{kp.name}"]["in_bytes"],
                                                   ref[f"kernels/{kp.name}"]["out_bytes"])


def test_shipped_envelope_certifies_with_one_capture_per_shard(static):
    assert static["violations"] == []
    assert intrinsic_findings(static) == []
    for fleet in static["fleet"]:
        assert set(fleet["step_captures"].values()) == {fleet["data_shards"]}
    for name, p in static["programs"].items():
        assert p["host_prims"] == [] and p["unknown"] == [], name
        assert not any(p["mutated_inputs"]), name
    assert static["programs"]["one_stage@data2/step"]["signatures"] == ["(f32[4,96,320,3])"]


# ------------------------------------------------ capture-freedom gate --

def test_small_envelope_certifies_capture_free():
    env = _small_env()
    trace = certify_rung(env.rungs[0], env)
    assert trace.violations == [] and trace.step_captures == 1
    assert trace.programs["early_exit/step"].signatures == ["(f32[2,96,320,3])"]


def test_injected_shape_dependent_branch_flips_the_gate(tmp_path):
    """A copy of batched/{engine,executor}.py whose sync tick first steps a
    *sliced* batch when occupancy < capacity: the sweep must report a
    recapture that fails the gate, where the shipped engine certifies
    clean."""
    pkg = tmp_path / "mutated_batched"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    src_dir = REPO / "src" / "repro_torch" / "batched"
    ex = (src_dir / "executor.py").read_text().replace("from ..", "from repro_torch.")
    (pkg / "executor.py").write_text(ex)
    src = (src_dir / "engine.py").read_text().replace("from ..", "from repro_torch.")
    needle = "self._exec.submit(slot_frames, payload=None)"
    assert needle in src
    inject = ("if len(slot_frames) < self.capacity:\n"
              "                self._exec._step_fn(self._exec._raw[: max(len(slot_frames), 1)])\n"
              "            " + needle)
    (pkg / "engine.py").write_text(src.replace(needle, inject))
    sys.path.insert(0, str(tmp_path))
    try:
        import mutated_batched.engine as meng
        env = _small_env()
        trace = certify_rung(env.rungs[0], env, engine_cls=meng.BatchedPerceptionEngine)
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("mutated_batched.engine", None)
        sys.modules.pop("mutated_batched.executor", None)
        sys.modules.pop("mutated_batched", None)
    assert trace.violations, "the sliced-batch step must be a new signature"
    progs, sigs, contexts = zip(*trace.violations)
    assert all(p == "early_exit/step" for p in progs) and "(f32[1,96,320,3])" in sigs
    findings = intrinsic_findings({"violations": [list(v) for v in trace.violations],
                                   "programs": {}})
    assert findings and findings[0].startswith("RECAPTURE")


# ------------------------------------------------------- drift gate --

@pytest.fixture(scope="module")
def shipped():
    assert TORCH_CERT.exists(), "commit analysis/torch_certificate.json (--regen --measure)"
    return json.loads(TORCH_CERT.read_text())


def test_drift_gate_fires_on_2x_prior_perturbation(shipped):
    rows = [r for r in shipped["cost_table"] if r.get("ratio") is not None]
    assert len(rows) == 12
    honest = {(r["rung"], r["batch_size"]): r["prior_s"] for r in rows}
    assert drift_findings(rows, honest) == []
    assert len(drift_findings(rows, {k: 2.0 * v for k, v in honest.items()})) == len(rows)


def test_committed_certificate_is_the_card_s(shipped):
    assert shipped["hardware"] == H100_SXM.to_dict()
    assert shipped["envelope_hash"] == "edd842b827d07805"
    assert "H100" in shipped["measured"]["card"] and "W" in shipped["measured"]["nvidia_smi"]
    for r in shipped["cost_table"]:
        assert r["bench_p50_s"] is not None and r["floor_s"] <= r["bench_p50_s"], r
        assert r["floor_s"] <= r["prior_s"], r


def test_check_reports_signature_drift_as_fatal(shipped):
    fresh = json.loads(json.dumps(shipped))
    fresh["programs"]["one_stage/step"]["signatures"] = ["(f32[1,1,1,1])"]
    fatal, _ = check(shipped, fresh)
    assert any(f.startswith("SIGNATURES one_stage/step") for f in fatal)


def test_check_reports_count_drift_as_note_only(shipped):
    fresh = json.loads(json.dumps(shipped))
    fresh["programs"]["one_stage/step"]["flops"] += 1.0
    fatal, notes = check(shipped, fresh)
    assert not fatal and any("flops" in n for n in notes)


# ------------------------------------------------------------------ CLI --

def test_shipped_tree_checks_clean_against_the_committed_certificate(tmp_path, monkeypatch,
                                                                      static):
    import repro_torch.analysis.cert.__main__ as cli
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(cli, "build_static", lambda: json.loads(json.dumps(static)))
    report = tmp_path / "report.txt"
    assert cert_main(["--check", "--diff-out", str(report), "--quiet"]) == 0, \
        report.read_text()
    assert "PASS" in report.read_text()


def test_cli_missing_certificate_is_a_usage_error(tmp_path):
    assert cert_main(["--check", "--cert", str(tmp_path / "nope.json")]) == 2
    assert cert_main(["--measure"]) == 2


def test_cli_envelope_regression_fails_the_gate(shipped, tmp_path, monkeypatch, static):
    import repro_torch.analysis.cert.__main__ as cli
    monkeypatch.setattr(cli, "build_static", lambda: json.loads(json.dumps(static)))
    stale = dict(shipped, envelope_hash="0" * 16)
    p = tmp_path / "stale.json"
    p.write_text(json.dumps(stale))
    report = tmp_path / "report.txt"
    assert cert_main(["--check", "--cert", str(p), "--diff-out", str(report), "--quiet"]) == 1
    assert "ENVELOPE" in report.read_text()
