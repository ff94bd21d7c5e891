#!/usr/bin/env python3
"""Greedy ties of tensor-parallel serving against one rank, on one card.

    python3 tools/tp_serve_ties.py [--models 2 4]

qwen3-4b whole at full width (random weights, seed 0) as
``chip_smoke.py``'s phase 10b serves it: prefill 1 x ``TP_PREFILL``, a
``TP_PROMPT``-token prompt, then ``TP_NEW`` greedy steps in a
``TP_CONTEXT``-slot ring, on one rank and on data=1 x model=m ranks
spawned on the one card over gloo, the ranks fed one rank's tokens.  For
each step it prints one rank's margin between its top two logits, the
largest difference between the ranks' logits and one rank's, and whether
the ranks' own greedy token equals one rank's; a differing token whose
margin lies within twice that difference is a tie at the resolution of
two roundings of bf16 products (``chip_smoke._serve_ties``).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", type=int, nargs="+", default=[2, 4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_serve_ties: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    cfg = get_config("qwen3-4b")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               (1, C.TP_PREFILL)).astype(np.int32)
    ref = C._one_rank_serve(dev, cfg, tokens)
    margins = [float(-np.diff(np.sort(lg[0])[::-1][:2])[0]) for lg in ref["logits"]]
    print(f"({smi}) one rank: tokens {np.concatenate(ref['tokens']).tolist()}; top-two margins "
          f"{[round(m, 4) for m in margins]}; max |logit| "
          f"{max(float(np.abs(lg).max()) for lg in ref['logits']):.3f}", flush=True)
    for m in args.models:
        job = dict(kind="tp_serve", cfg=cfg, mesh=dict(data=1, model=m), tokens=tokens,
                   prompt=C.TP_PROMPT, force=ref["tokens"], context=C.TP_CONTEXT)
        with tempfile.TemporaryDirectory() as d:
            res = run_ranks(C._sharded_ranks, m, init_file=str(Path(d) / "pg"),
                            backend="gloo", args=([job], [str(dev)] * m), timeout=900)
        w = res[0][0]
        diffs = [float(np.abs(a - b).max()) for a, b in zip(w["logits"], ref["logits"])]
        same = [bool((a == b).all()) for a, b in zip(w["tokens"], ref["tokens"])]
        clear, ties = C._serve_ties(w, ref)
        print(f"({smi}) model={m}: greedy tokens equal at {sum(same)} of {len(same)} steps; "
              f"steps with a clear margin (over twice the difference) {clear}, all equal; "
              f"ties at the others (step, margin, difference) {ties}; largest logit "
              f"difference a step "
              f"{[round(x, 4) for x in diffs]}; steps whose margin is within it "
              f"{[i for i, (g, x) in enumerate(zip(margins, diffs)) if g <= x]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
