#!/usr/bin/env python3
"""Controls for internvl2-1b's q and k bias bounds in
``tests/test_torch_sharded_train.py``, on the CPU.

    python3 tools/tp_bias_controls.py [--seeds 4]

The file's internvl2 job (smoke config, f32, 4 AdamW steps at lr 1e-4 and
eps 1e-6 of 4 x 64 batches) trained by the one-device ``Trainer`` from
seed 0, and again from the same initial weights moved by one rounding
(each element times 1 + s * 2**-24, s = +-1 drawn by seed).  Prints, for
each seed and for the data=1 x model=2 run (two spawned gloo ranks, two
threads each, as the test runs them), how far each final bias leaf and
the other leaves lie from the one-device run, relative to the leaf's
largest element: the distance at which the test's ``LEAF_TOL`` reading is
rounding magnified by AdamW, not a fault.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import torch_sharded_ranks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.models import Model, from_numpy  # noqa: E402
from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig, Trainer,  # noqa: E402
                               adamw_init, synthetic_batches)
from repro_torch.train.optimizer import _walk  # noqa: E402

ARCH, B, S, STEPS = "internvl2-1b", 4, 64, 4
OPT = dict(lr=1e-4, eps=1e-6, warmup_steps=1, total_steps=8)
BIASES = ("layers/attn/bq", "layers/attn/bk", "layers/attn/bv")


def _flat(tree) -> dict:
    return {"/".join(k): v.detach().numpy().copy() for k, v in _walk(tree)}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def one_device(init: dict | None = None) -> tuple[dict, dict]:
    """(initial, final) leaves of the one-device run, from seed 0 or from
    ``init``."""
    model = Model(get_config(ARCH, smoke=True))
    tr = Trainer(model, "cpu", TrainConfig(opt=AdamWConfig(**OPT), log_every=1))
    if init is None:
        p, st = tr.init(0)
    else:
        p = from_numpy(_nest(init), "cpu")
        for _, leaf in _walk(p):
            leaf.requires_grad_(True)
        st = adamw_init(p)
    start = _flat(p)
    p, _ = tr.fit(p, st, synthetic_batches(model.cfg, DataConfig(B, S)), STEPS)
    return start, _flat(p)


def _err(got: dict, want: dict, keys) -> float:
    return max(float(np.abs(got[k] - want[k]).max()) / max(float(np.abs(want[k]).max()), 1e-30)
               for k in keys)


def _report(tag: str, got: dict, want: dict) -> None:
    rest = [k for k in want if k not in BIASES]
    print(f"{tag}: " + ", ".join(f"{k.rsplit('/', 1)[1]} {_err(got, want, [k]):.3e}"
                                 for k in BIASES)
          + f", other leaves {_err(got, want, rest):.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(2)
    init, base = one_device()
    for seed in range(args.seeds):
        sign = np.random.default_rng(seed)
        moved = {k: (v * (1 + sign.choice([-1.0, 1.0], v.shape) * 2.0 ** -24)).astype(v.dtype)
                 for k, v in init.items()}
        _report(f"one rounding of the init, seed {seed}", one_device(moved)[1], base)
    job = dict(kind="train", arch=ARCH, mesh=dict(data=1, model=2), fsdp=False, opt=OPT,
               batch=B, seq=S, steps=STEPS)
    with tempfile.TemporaryDirectory() as d:
        ranks = run_ranks(torch_sharded_ranks.run_jobs, 2, init_file=str(Path(d) / "pg"),
                          args=([job],), threads=2, timeout=300)
    _report("data=1 x model=2", ranks[0][0]["full"], base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
