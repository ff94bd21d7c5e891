#!/usr/bin/env python3
"""Negative controls for ``chip_smoke.py``'s ``SHARD_BAND``, and the
many-card olmoe-1b-7b run, on the card.

    python3 tools/shard_band_controls.py                # one card
    python3 tools/shard_band_controls.py --many-cards   # every card

Without arguments: phase 10's full-width cut (qwen3-4b at
``SHARD_LAYERS`` layers, FSDP at data=2, two ranks on the one card over
gloo) against one rank of the same cut, three times in one spawned group:
as committed; with the gradient reduced in its own dtype (bf16) instead of
f32; and with each rank's gradient left unreduced (its own rows only).
Prints each step's loss against the one rank's, relative, and whether it
falls inside ``SHARD_BAND``.  The faults replace ``layout.reduce_grads``
(each leaf in turn) in the spawned ranks only; the committed sources are
not changed.

``--many-cards``: ``chip_smoke.sharded_many_cards`` over every visible
card (olmoe-1b-7b whole, FSDP over NCCL, one rank per card).
"""
from __future__ import annotations

import argparse
import math
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
from repro_torch.distributed import layout  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402

COMMITTED = layout.reduce_grads


def reduce_in_own_dtype(grad, spec, mesh, data_axes):
    """``layout.reduce_grad`` with its collectives on the gradient's own
    dtype (no f32 copy)."""
    data = tuple(a for a in mesh.axis_names if a in data_axes and mesh.shape[a] > 1)
    group = mesh.group(data)
    ents = layout.entries(spec, mesh)
    lead = next((i for i, e in enumerate(ents) if e[:len(data)] == data), None)
    if lead is None:
        x = grad.clone()
        dist.all_reduce(x, group=group)
        return layout.take_block(x, spec, mesh)
    nd = math.prod(mesh.shape[a] for a in data)
    xm = grad.movedim(lead, 0).contiguous()
    out = torch.empty((xm.shape[0] // nd, *xm.shape[1:]), dtype=xm.dtype, device=xm.device)
    layout.reduce_scatter_flat(out, xm, group)
    part = out.movedim(0, lead)
    rest = list(ents)
    rest[lead] = ents[lead][len(data):]
    return part[layout._slices(tuple(part.shape), tuple(rest), mesh)].contiguous()


def own_rows_only(grad, spec, mesh, data_axes):
    """No reduction: the rank's block of its own rows' gradient."""
    return layout.take_block(grad, spec, mesh)


def _each(fault):
    """A fault of one leaf as ``layout.reduce_grads`` of several."""
    return lambda grads, specs, mesh, data_axes: [fault(g, sp, mesh, data_axes)
                                                  for g, sp in zip(grads, specs)]


FAULTS = {"committed": COMMITTED, "bf16 reduction": _each(reduce_in_own_dtype),
          "unreduced": _each(own_rows_only)}


def _control_ranks(rank: int, jobs: list, devices: list) -> list:
    out = []
    for job in jobs:
        layout.reduce_grads = FAULTS[job["fault"]]
        out += C._sharded_ranks(rank, [job], devices)
    layout.reduce_grads = COMMITTED
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--many-cards", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("shard_band_controls: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.many_cards:
        C.sharded_many_cards(smi, torch.cuda.device_count())
        return 0
    dev = torch.device("cuda:0")
    model, opt, one, *_ = C.one_rank_width(dev)
    print(f"({smi}) one rank, qwen3-4b {C.SHARD_LAYERS} layers, {C.SHARD_B} x {C.SHARD_S}: "
          f"losses {[m['loss'] for m in one]}", flush=True)
    job = dict(kind="width", cfg=model.cfg, opt=opt, data=2, batch=C.SHARD_B, seq=C.SHARD_S,
               steps=C.SHARD_STEPS)
    with tempfile.TemporaryDirectory() as d:
        ranks = run_ranks(_control_ranks, 2, init_file=str(Path(d) / "pg"), backend="gloo",
                          args=([dict(job, fault=f) for f in FAULTS], [str(dev)] * 2),
                          timeout=900)
    for j, name in enumerate(FAULTS):
        for r in range(2):
            ms = ranks[r][j]["metrics"]
            rel = C.band_readings(ms, one)
            inside = all(x <= (C.SHARD_BAND[0] if i == 0 else C.SHARD_BAND[1])
                         for i, x in enumerate(rel))
            same = [m["loss"] for m in ms] == [m["loss"] for m in ranks[r][0]["metrics"]]
            print(f"({smi}) {name}, rank {r}: losses {[m['loss'] for m in ms]}; relative to one "
                  f"rank {[f'{x:.3e}' for x in rel]}; {'inside' if inside else 'outside'} "
                  f"SHARD_BAND {C.SHARD_BAND}; losses equal to the committed run's: {same}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
