#!/usr/bin/env python3
"""Controls for ``chip_smoke.py``'s ``SHARD_BAND`` under tensor-parallel
training, on the card.

    python3 tools/tp_band_controls.py

First the decode kernel's row log-sum-exp against its plain version
(``chip_smoke.tp_lse_kernel``, which builds the kernel).  Then phase 10b's
training cut (qwen3-4b at ``SHARD_LAYERS`` layers, data=1 x model=2, two
ranks on the one card over gloo) against one rank of the same cut, in one
spawned group, once per variant:

- ``committed``: the sources as they are (the row-parallel partial sums,
  each a bf16 product, summed over ``model`` in f32);
- ``bf16 reduction``: the sums over ``model`` taken in the partials' own
  dtype;
- ``f32 partials``: the row-parallel products (attention's output
  projection, the MLP's down projection) written in f32 and summed in
  f32, rounded to bf16 once, as one product over the whole K rounds;
- ``unreduced``: each rank keeps its own partial sums (a negative control).

Prints each step's loss against the one rank's, relative, and whether it
falls inside ``SHARD_BAND``.  The variants replace functions in the
spawned ranks only; the committed sources are not changed.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from repro_torch.distributed import tp  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402

COMMITTED = (tp.ModelParallel.all_reduce, attention.leave, layers.mlp, attention._out_proj)


def reduce_in_own_dtype(self, x, op="sum"):
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=self.group)
    return y


def _mlp(params, x, tp_, f32: bool, reduce: bool):
    x = tp.enter(x, tp_)
    g, u = x @ params["gate"], x @ params["up"]
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y = h.float() @ params["down"].float() if f32 else h @ params["down"]
    return (tp.leave(y, tp_) if reduce else y).to(x.dtype)


def out_proj_f32(out, wo):
    h, dh, d = wo.shape
    return out.flatten(-2).float() @ wo.reshape(h * dh, d).float()


FAULTS = ("committed", "bf16 reduction", "f32 partials", "unreduced")


def _apply(fault: str) -> None:
    """Install ``fault``'s functions (module docstring); the MLP's
    replacement serves only the gated MLP of the dense cut."""
    tp.ModelParallel.all_reduce, attention.leave, layers.mlp, attention._out_proj = COMMITTED
    if fault == "bf16 reduction":
        tp.ModelParallel.all_reduce = reduce_in_own_dtype
    elif fault == "unreduced":
        attention.leave = lambda x, tp_: x
        layers.mlp = lambda p, x, tp_=None: _mlp(p, x, tp_, False, False)
    elif fault == "f32 partials":
        # the attention output leaves f32 and is rounded by the residual add
        attention.leave = lambda x, tp_: tp.leave(x, tp_).to(torch.bfloat16)
        attention._out_proj = out_proj_f32
        layers.mlp = lambda p, x, tp_=None: _mlp(p, x, tp_, True, True)


def _control_ranks(rank: int, jobs: list, devices: list) -> list:
    out = []
    for job in jobs:
        _apply(job["fault"])
        out += C._sharded_ranks(rank, [job], devices)
    _apply("committed")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_band_controls: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    C.tp_lse_kernel(dev, f"({smi})")
    model, opt, one, *_ = C.one_rank_width(dev)
    print(f"({smi}) one rank, qwen3-4b {C.SHARD_LAYERS} layers, {C.SHARD_B} x {C.SHARD_S}: "
          f"losses {[m['loss'] for m in one]}", flush=True)
    job = dict(kind="width", cfg=model.cfg, opt=opt, mesh=dict(data=1, model=2), fsdp=False,
               batch=C.SHARD_B, seq=C.SHARD_S, steps=C.SHARD_STEPS)
    with tempfile.TemporaryDirectory() as d:
        ranks = run_ranks(_control_ranks, 2, init_file=str(Path(d) / "pg"), backend="gloo",
                          args=([dict(job, fault=f) for f in FAULTS], [str(dev)] * 2),
                          timeout=900)
    for j, name in enumerate(FAULTS):
        for r in range(2):
            w = ranks[r][j]
            rel = C.band_readings(w["metrics"], one)
            inside = all(x <= (C.SHARD_BAND[0] if i == 0 else C.SHARD_BAND[1])
                         for i, x in enumerate(rel))
            print(f"({smi}) {name}, rank {r}: losses {[m['loss'] for m in w['metrics']]}; "
                  f"relative to one rank {[f'{x:.3e}' for x in rel]}; "
                  f"{'inside' if inside else 'outside'} SHARD_BAND {C.SHARD_BAND}; step mean "
                  f"{w['step_ms']:.3f} ms; peak {w['peak'] / 1e9:.3f} GB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
