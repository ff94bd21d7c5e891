"""CPU fixtures: a checkout-like root holding a ``BENCHMARK.json`` of four
tiny cells (``tests/tiny``: rwkv6-3b cut to CPU size, the ``infer`` and
``train`` kinds at short lengths) beside the benchmark's own
per-layer metric readers, so that the harness runs whole on the CPU with
the program's plain kernel versions."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = Path(__file__).resolve().parent / "tiny"
CELLS = ["ssm-tiny.infer-tiny", "ssm-tiny.train-tiny"]


def tiny_bench() -> dict:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": n, "config": n.split(".")[0], "traffic": n.split(".")[1],
                           "chips": 1, "why": "a CPU-sized cell for the tests"} for n in CELLS]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "infer" if "infer" in m["name"] else "train"
            m["workloads"] = [n for n in CELLS if kind in n]
    return bench


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(TINY, root / "portbench")
    shutil.copytree(REPO / "portbench" / "metrics", root / "portbench" / "metrics")
    (root / "BENCHMARK.json").write_text(json.dumps(tiny_bench()))
    return root
