#!/usr/bin/env python3
"""The scans' backward kernels of one or more source trees, timed in turn on
the card in one run: the check that a redesign of
``csrc/rwkv6_scan_bwd.cu`` / ``csrc/mamba2_ssd_bwd.cu`` is faster than its
parent on the same card.

    python3 tools/scan_grad_ab.py ROOT [ROOT ...]

Each ROOT is a checkout: its ``chip_smoke.py`` and ``src/repro_torch`` are
imported, in a fresh process per ROOT, in the order given (pass the parent
and the change as parent, change, change, parent), and its
``chip_smoke.time_scan_grads`` runs: each kernel at the training shapes
(rwkv6-3b (2, 1024, 40, 64), zamba2-2.7b (2, 1024, 80, 64, 64)) and the
rank shapes, medians of ROUNDS CUDA-graph replays, beside the plain version
and the bound (the kernels are built from ROOT's sources first); before
that, in the process's first profiler sessions, each launch of one call at
the training shapes (torch.profiler, the mean of 5 calls).  Prints the
card's name and power limit first, each process's log, and per ROOT one
line of the kernels' times and one of each kernel's launches.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, re, sys
sys.path.insert(0, sys.argv[1] + "/src")
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as C
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_bwd_cuda
from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_bwd_cuda
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(7)
# each launch of a call at the training shapes, from this process's first
# profiler sessions: mean device ms over REPS calls
REPS = 5
launches = {}
for name, shape in (("rwkv6_wkv_bwd", C.RWKV_TRAIN), ("mamba2_ssd_bwd", C.MAMBA_TRAIN)):
    if name == "rwkv6_wkv_bwd":
        ins, dy = C.rwkv6_inputs(gen, shape, 0.5, dev), C.randn(gen, shape, torch.float32, dev)
        call = lambda: rwkv6_wkv_bwd_cuda(*ins, dy, C.RWKV_CHUNK)
    else:
        ins, dy = C.mamba2_inputs(gen, shape, dev), C.randn(gen, shape[:4], torch.float32, dev)
        call = lambda: mamba2_ssd_bwd_cuda(*ins, dy, C.MAMBA_CHUNK, C.MAMBA_HB)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            call()
        torch.cuda.synchronize()
    launches[name] = {(re.findall(r"(\w+)\(", e.key) or [e.key])[0]: C._device_us(e) / 1e3 / REPS
                      for e in prof.key_averages() if C._device_us(e) > 0}
res = C.time_scan_grads(gen, dev)
print(json.dumps({"times": res, "launches": launches}))
"""


def rows(res: dict) -> list[tuple[str, float]]:
    """(label, kernel ms) of every shape in a ``time_scan_grads`` result."""
    out = []
    for name, row in res.items():
        out.append((f"{name} training", row["ms"]))
        for r in row.get("rank_shapes", []):
            hb = f" hb {r['head_block']}" if r["head_block"] else ""
            out.append((f"{name} {tuple(r['shape'])}{hb}", r["ms"]))
    return out


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for root in argv:
        proc = subprocess.run([sys.executable, "-c", CHILD, str(Path(root).resolve())],
                              capture_output=True, text=True, cwd=root)
        lines = proc.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(f"  [{root}] {line}")
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        out = json.loads(lines[-1])
        print(f"{root}: " + "; ".join(f"{label} {ms:.4f} ms" for label, ms in rows(out["times"])),
              flush=True)
        for name, parts in out["launches"].items():
            print(f"{root}: {name} training shape, each launch (profiler, mean of a call): "
                  + ", ".join(f"{k} {ms:.4f} ms" for k, ms in parts.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
