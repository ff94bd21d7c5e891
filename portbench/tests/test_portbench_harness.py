"""The harness on the CPU: the result's line, the end-to-end arithmetic over
the whole window, the traffic's determinism, files found by name, the
frozen yardstick, and what a run may import."""
from __future__ import annotations

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from tiny_cells import CELLS, REPO

from portbench import harness, timeline, traffic_gen, work
from portbench.kinds import infer


def _run(root, name: str, trace: bool, seed: int = 2 ** 31 + 11) -> tuple[harness.Cell, dict]:
    cell = harness.load_cell(name, root=root, bench_dir=root / "portbench")
    kind = __import__(f"portbench.kinds.{cell.kind}", fromlist=["run"])
    return cell, kind.run(cell, seed, 0.5, trace, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("name", CELLS)
def test_result_line_keys(tiny_root, name):
    cell, out = _run(tiny_root, name, trace=True)
    correct, checks = harness.judge(out["readings"], cell.limits)
    line = json.loads(harness.result_line(
        correct, out["attempted"], out["failed"], harness.read_per_layer(cell, out["trace"]),
        harness.device_info(torch.device("cpu"), 0), checks, out["trace"].breakdown()))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert correct is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(checks) == set(cell.limits["limits"])
    assert {m["name"] for m in cell.end_to_end} >= set(out["end_to_end"])
    assert "setup_s" in out["end_to_end"] and len(out["end_to_end"]) >= 2
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    mfu = line["metrics"][f"mfu.{cell.kind}"]["value"]
    assert 0 < mfu < 100


def test_tail_and_rate_cover_the_whole_window():
    served = infer.Served(latencies_ns=[i * 1_000_000 for i in range(1, 101)],
                          lengths=[100] * 50 + [300] * 50, outputs=[], window_s=4.0, trace=None)
    e2e = infer.end_to_end(served, batch=2)
    assert e2e["infer_p95_ms"] == 95.0
    assert e2e["infer_tokens_per_s"] == 2 * (50 * 100 + 50 * 300) / 4.0


def test_same_seed_same_traffic():
    mix = json.loads((REPO / "portbench" / "traffic" / "infer.json").read_text())
    mix["pool_tokens"] = 1 << 16
    a, b = traffic_gen.Requests(mix, 2 ** 31 + 5, 65536), traffic_gen.Requests(mix, 2 ** 31 + 5, 65536)
    c = traffic_gen.Requests(mix, 2 ** 31 + 6, 65536)
    assert [a.length(i) for i in range(200)] == [b.length(i) for i in range(200)]
    assert all(np.array_equal(a.tokens(i), b.tokens(i)) for i in range(20))
    assert [a.length(i) for i in range(64)] != [c.length(i) for i in range(64)]
    # every seed asks for the same lengths in each cycle, in its own order
    assert sorted(a.length(i) for i in range(64)) == sorted(c.length(i) for i in range(64))
    assert a.tokens(0).shape == (2, a.length(0))
    assert not np.array_equal(a.tokens(0)[0], a.tokens(0)[1])
    t1 = traffic_gen.train_batch(7, 3, 512, 2, 64, 1.1)
    assert np.array_equal(t1, traffic_gen.train_batch(7, 3, 512, 2, 64, 1.1))
    assert not np.array_equal(t1, traffic_gen.train_batch(7, 4, 512, 2, 64, 1.1))


def test_zipf_tokens_are_the_programs():
    """The frozen generator draws the program's training batches bit for
    bit (``train/data.py::make_batch_np``)."""
    from repro_torch.configs import get_config
    from repro_torch.train import DataConfig, make_batch_np

    cfg = get_config("rwkv6-3b", smoke=True)
    ours = traffic_gen.train_batch(3, 5, cfg.vocab_size, 2, 32, 1.1)
    theirs = make_batch_np(cfg, DataConfig(batch=2, seq_len=32, seed=3), 5)["tokens"]
    assert np.array_equal(ours, theirs)


def test_a_new_cell_is_found_by_name(tiny_root, tmp_path):
    """A new cell is its files and its entries: nothing else changes."""
    import shutil

    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "ssm-tiny.json").read_text())
    cfg["name"], cfg["num_layers"] = "ssm-deeper", 3
    (pb / "configs" / "ssm-deeper.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "infer-tiny.json").read_text())
    mix["length_max"] = 64
    (pb / "traffic" / "short-tiny.json").write_text(json.dumps(mix))
    (pb / "limits" / "ssm-deeper.short-tiny.json").write_text(
        (pb / "limits" / "ssm-tiny.infer-tiny.json").read_text())
    (pb / "metrics" / "requests_seen.short.py").write_text(
        "def read(trace, cell):\n    return float(len(trace.spans))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ssm-deeper", "source": "x", "file": "x", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "ssm-deeper.short-tiny", "config": "ssm-deeper",
                               "traffic": "short-tiny", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("infer_"):
            m["workloads"].append("ssm-deeper.short-tiny")
    bench["per_layer"].append({"name": "requests_seen.short", "unit": "requests",
                               "better": "higher", "source": "program_span", "layer": "harness",
                               "moves": "infer_tokens_per_s",
                               "workloads": ["ssm-deeper.short-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, out = _run(root, "ssm-deeper.short-tiny", trace=True)
    assert cell.config["num_layers"] == 3 and max(out["trace"].spans[i].shape["length"]
                                                  for i in range(len(out["trace"].spans))) <= 64
    got = harness.read_per_layer(cell, out["trace"])
    assert got["requests_seen.short"]["value"] == cell.traffic["traced_requests"]
    assert "wkv_fwd_roofline.infer" not in got      # the CPU launches no CUDA kernel


def test_benchmark_files_exist_for_every_entry():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = REPO / "portbench"
    for w in bench["workloads"]:
        cfg = json.loads((pb / "configs" / f"{w['config']}.json").read_text())
        assert cfg["name"] == w["config"]
        assert (pb / "traffic" / f"{w['traffic']}.json").exists()
        assert (pb / "limits" / f"{w['name']}.json").exists()
        assert (pb / "reference" / f"{cfg['family']}.py").exists()
    for m in bench["per_layer"]:
        assert (pb / "metrics" / f"{m['name']}.py").exists()


def test_least_work_pins():
    """The frozen least work gives the program's present bounds (ms)."""
    assert math.isclose(work.wkv_fwd(4, 1024, 40, 64).seconds() * 1e3, 0.0626, rel_tol=2e-3)
    assert math.isclose(work.ssd_bwd(2, 1024, 80, 64, 64).seconds() * 1e3, 0.0407, rel_tol=2e-3)
    assert math.isclose(work.wkv_bwd(2, 1024, 40, 64).seconds() * 1e3, 0.0563, rel_tol=2e-3)
    assert math.isclose(work.ssd_fwd(4, 1024, 80, 64, 64).seconds() * 1e3, 0.0511, rel_tol=2e-3)
    assert math.isclose(work.flash_fwd(4, 1024, 32, 8, 128).seconds() * 1e3, 0.0348, rel_tol=2e-3)


def test_least_work_matches_the_programs_declared_costs():
    from repro_torch.kernels import cost
    import torch as t

    ours = work.flash_fwd(2, 4096, 32, 32, 80)
    theirs = cost.flash_attention_cost((2, 4096, 32, 80), (2, 4096, 32, 80), t.bfloat16)
    assert ours.flops == theirs.flops and ours.bytes == theirs.bytes
    ours, theirs = work.wkv_fwd(2, 4096, 40, 64), cost.rwkv6_wkv_cost((2, 4096, 40, 64))
    assert ours.flops == theirs.flops and ours.bytes == theirs.bytes
    ours, theirs = work.ssd_fwd(2, 4096, 80, 64, 64), cost.mamba2_ssd_cost((2, 4096, 80, 64), 64)
    assert ours.flops == theirs.flops and ours.bytes == theirs.bytes


def test_model_flops_is_the_programs_without_the_embedding():
    from repro_torch.configs import get_config
    from repro_torch.configs import InputShape
    from repro_torch.launch.roofline import model_flops
    from portbench.reference import ssm

    cfg = json.loads((REPO / "portbench" / "configs" / "rwkv6-3b.json").read_text())
    from portbench import weights
    n = work.n_params({p: s for p, s, _ in weights.specs(ssm.layout(cfg))})
    body, head = work.useful_params(cfg, n)
    theirs = model_flops(get_config("rwkv6-3b"), InputShape("x", 4096, 2, "train"))
    assert theirs == 6.0 * n * 2 * 4096
    assert work.train_flops(cfg, n, 2, 4096) == theirs - 6.0 * head * 2 * 4096


def test_union_counts_overlap_once():
    us = 1000
    ops = [(0, 10 * us, "a"), (5 * us, 15 * us, "b"), (20 * us, 30 * us, "c")]
    assert timeline.union_ns(ops) == 25 * us
    tr = timeline.Trace(ops=ops, host=[(12 * us, 40 * us, "step"), (14 * us, 40 * us, "sync")],
                        spans=[timeline.Span("step", 0, 40 * us, {})])
    assert math.isclose(tr.idle_share(), 15 / 40)
    assert tr.gaps() == [(15 * us, 20 * us), (30 * us, 40 * us)]
    (name, s), = tr.breakdown()["idle_gaps"]
    assert name == "sync" and s == pytest.approx(15e-6)
    assert tr.breakdown()["device_ops"][0] == ["a", pytest.approx(10e-6)]


def _loaded_by(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    """A whole tiny run in a fresh process, then every loaded module's
    top-level name, whole: ``repro_torch`` is the program, ``repro`` and
    ``jax`` may not appear."""
    code = (
        "import sys, json, torch\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        "from portbench.kinds import infer\n"
        f"root = Path({str(tiny_root)!r})\n"
        "cell = harness.load_cell('ssm-tiny.infer-tiny', root=root, bench_dir=root / 'portbench')\n"
        "infer.run(cell, 5, 0.2, False, torch.device('cpu'), 0.0)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _loaded_by(code)
    assert "repro_torch" in tops
    assert not set(tops) & set(harness.FORBIDDEN)
    assert harness.forbidden_modules() == [] or "repro" not in tops


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_modules() == [m for m in harness.forbidden_modules()
                                           if m.split(".")[0] in harness.FORBIDDEN]
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert "repro.models" in harness.forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, json\n"
            f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
            "import portbench.reference.ssm, portbench.weights\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _loaded_by(code)
    assert "repro_torch" not in tops and "repro" not in tops and "jax" not in tops
