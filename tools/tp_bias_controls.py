#!/usr/bin/env python3
"""Controls for the bounds of the zero-initialised leaves and of the
gradient norm in ``tests/test_torch_sharded_train.py``, on the CPU.

    python3 tools/tp_bias_controls.py [--arch internvl2-1b] [--seeds 4]

The file's trajectory jobs of ``--arch`` (smoke config, f32, 4 AdamW steps
at lr 1e-4 and eps 1e-6 of 4 x 64 batches) trained by the one-device
``Trainer`` from seed 0, and again from the same initial weights moved by
one rounding (each element times 1 + s * 2**-24, s = +-1 drawn by seed).
Prints, for each seed and for each of the file's tensor-parallel jobs of
the arch (spawned gloo ranks, two threads each, as the test runs them),
how far each final leaf that starts at zero (internvl2-1b's q/k/v biases;
rwkv6-3b's token-shift mixes, decay base and bonus; zamba2-2.7b's dt bias
and log A) and the other leaves lie from the one-device run, relative to
the leaf's largest element, and the largest relative difference of a
step's gradient norm.  A zero-initialised leaf's largest element after 4
steps is about 4 lr, and AdamW turns last-bit differences of its gradient
elements near eps into a good part of lr: the control's readings are the
distance at which the test's ``LEAF_TOL`` and ``LOSS_RTOL`` readings are
that rounding magnified, not a fault.
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

B, S, STEPS = 4, 64, 4
OPT = dict(lr=1e-4, eps=1e-6, warmup_steps=1, total_steps=8)
# each arch's tensor-parallel trajectory jobs in the test: (name, mesh, ruleset overrides)
JOBS = {"internvl2-1b": [("internvl2-model2", dict(data=1, model=2), {})],
        "rwkv6-3b": [("rwkv6-model2", dict(data=1, model=2), {}),
                     ("rwkv6-heads-whole", dict(data=1, model=2), dict(heads=None))],
        "zamba2-2.7b": [("zamba2-model2", dict(data=1, model=2), {}),
                        ("zamba2-model4", dict(data=1, model=4), {})]}


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


def one_device(arch: str, init: dict | None = None) -> tuple[dict, dict, list]:
    """(initial leaves, final leaves, every step's gradient norm) of the
    one-device run, from seed 0 or from ``init``."""
    model = Model(get_config(arch, smoke=True))
    tr = Trainer(model, "cpu", TrainConfig(opt=AdamWConfig(**OPT), log_every=1))
    if init is None:
        p, st = tr.init(0)
    else:
        p = from_numpy(_nest(init), "cpu")
        for _, leaf in _walk(p):
            leaf.requires_grad_(True)
        st = adamw_init(p)
    start = _flat(p)
    norms: list = []
    p, _ = tr.fit(p, st, synthetic_batches(model.cfg, DataConfig(B, S)), STEPS,
                  log=lambda i, m: norms.append(m["grad_norm"]))
    return start, _flat(p), norms


def _err(got: dict, want: dict, keys) -> float:
    return max(float(np.abs(got[k] - want[k]).max()) / max(float(np.abs(want[k]).max()), 1e-30)
               for k in keys)


def _report(tag: str, got: dict, want: dict, zeros: list, norms: list, want_norms: list) -> None:
    rest = [k for k in want if k not in zeros]
    dn = max(abs(a - b) / abs(b) for a, b in zip(norms, want_norms))
    print(f"{tag}: " + ", ".join(f"{k} {_err(got, want, [k]):.3e}" for k in zeros)
          + f", other leaves {_err(got, want, rest):.3e}; grad_norm {dn:.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internvl2-1b", choices=sorted(JOBS))
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(2)
    init, base, base_norms = one_device(args.arch)
    zeros = [k for k, v in init.items() if not v.any()]
    for seed in range(args.seeds):
        sign = np.random.default_rng(seed)
        moved = {k: (v * (1 + sign.choice([-1.0, 1.0], v.shape) * 2.0 ** -24)).astype(v.dtype)
                 for k, v in init.items()}
        _, final, norms = one_device(args.arch, moved)
        _report(f"one rounding of the init, seed {seed}", final, base, zeros, norms, base_norms)
    for name, mesh, overrides in JOBS[args.arch]:
        job = dict(kind="train", arch=args.arch, mesh=mesh, fsdp=False, opt=OPT, batch=B,
                   seq=S, steps=STEPS, overrides=overrides)
        with tempfile.TemporaryDirectory() as d:
            ranks = run_ranks(torch_sharded_ranks.run_jobs, mesh["model"],
                              init_file=str(Path(d) / "pg"), args=([job],), threads=2,
                              timeout=300)
        _report(name, ranks[0][0]["full"], base, zeros,
                [m["grad_norm"] for m in ranks[0][0]["metrics"]], base_norms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
