"""The harness: finds a cell's files by the names in ``BENCHMARK.json``, runs
its traffic kind (``kinds/<kind>.py``) on the program, reads the per-layer
metrics (``metrics/<metric>.py``) from a traced run, judges the outputs
against the plain reference (``reference/<family>.py``) by the cell's limits
(``limits/<cell>.json``), and prints the result's line.

Files a cell needs, all found by name:

* ``configs/<config>.json``: the configuration as it is run (the program's
  ``ModelConfig`` fields over its registry entry), its source and cuts;
* ``traffic/<mix>.json``: the mix's kind and parameters;
* ``metrics/<metric>.py`` for each per-layer metric that lists the cell;
* ``limits/<cell>.json``: each compared number's limit and the readings it
  was set from;
* ``reference/<family>.py`` for the configuration's family.

The program is ``repro_torch`` under ``src/``; nothing here imports the JAX
package.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Callable, Optional

import torch

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# top-level modules that may not be loaded in a run: the JAX stack and the
# JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list           # the BENCHMARK.json entries this cell reports
    per_layer: list            # (entry, reader) this cell reports
    reference: Any             # the family's reference module
    n_params: int = 0

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT, bench_dir: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files read from
    ``bench_dir`` (default: the folder of this file)."""
    bench_dir = HERE if bench_dir is None else bench_dir
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    config = json.loads((bench_dir / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [(m, _load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                  f"portbench_metric_{m['name'].replace('.', '_')}").read)
                 for m in bench["per_layer"] if _reports(m, name)]
    reference = importlib.import_module(f"portbench.reference.{config['family']}")
    return Cell(name=name, workload=w, config=config, traffic=traffic, limits=limits,
                end_to_end=e2e, per_layer=per_layer, reference=reference)


def model_config(cfg: dict):
    """The program's ``ModelConfig``: its registry entry with every field
    the configuration file gives."""
    from repro_torch.configs import get_config

    base = get_config(cfg["registry"])
    fields = {f.name for f in dataclasses.fields(base)} - {"name", "source"}
    return base.replace(**{k: v for k, v in cfg.items() if k in fields})


def check_layout(model, layout: dict) -> None:
    """Raise unless the reference's layout has the program's leaves, by key
    path and shape: the two sides must take the same weights."""
    from . import weights
    from .reference.common import leaves

    want = {p: tuple(s.shape) for p, s in leaves(model.specs())}
    have = {p: s for p, s, _ in weights.specs(layout)}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))
        raise RuntimeError(f"the reference's weight layout differs from the program's: {diff}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct where every number
    the limits name is present, finite and not above its limit."""
    checks, ok = {}, True
    for name, lim in limits["limits"].items():
        v = readings.get(name)
        good = v is not None and v == v and abs(v) != float("inf") and v <= lim
        ok = ok and good
        checks[name] = {"value": v, "limit": lim}
    return ok, checks


def read_per_layer(cell: Cell, trace) -> dict:
    out = {}
    for entry, reader in cell.per_layer:
        v = reader(trace, cell)
        if v is not None:
            out[entry["name"]] = {"value": v, "unit": entry["unit"]}
    return out


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: Optional[dict] = None) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def print_checks(checks: dict, write: Callable[[str], Any]) -> None:
    for name, c in checks.items():
        write(f"check {name} {c['value']!r} limit {c['limit']!r}\n")
