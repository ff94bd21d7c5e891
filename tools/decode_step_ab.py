#!/usr/bin/env python3
"""qwen3-4b's eager decode step on the card, from one or more source trees
in turn, in one run: the check that a change to the kernels' entry
points does not move the step.

    python3 tools/decode_step_ab.py ROOT [ROOT ...]

Each ROOT is a checkout (its ``src/repro_torch`` is imported, in a fresh
process per ROOT, in the order given: pass the parent and the change as
parent, change, change, parent).  Each process builds qwen3-4b at full
width in bf16 with seeded random weights and runs ``Engine.generate`` as
``chip_smoke.py``'s ``phase_model`` does (batch 4, context 1024, a 64-token
prompt, 32 new tokens) ``REPEATS`` times, and prints each run's decode step
mean, CV and p99.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import json
import subprocess
import sys

REPEATS = 3
CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1] + "/src")
import numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.runtime import Engine, ServeConfig
torch.backends.cuda.matmul.allow_tf32 = False
model = Model(get_config("qwen3-4b"))
params = model.init(seed=0, device="cuda")
prompt = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (4, 64)).astype(np.int32)
out = []
for _ in range(int(sys.argv[2])):
    engine = Engine(model, ServeConfig(batch=4, context=1024), device="cuda")
    engine.generate(params, prompt, max_new_tokens=32)
    rep = engine.report()
    out.append({k: rep[k] for k in ("mean_s", "cv", "p99_s", "jobs")})
print(json.dumps(out))
"""


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    for root in argv:
        res = subprocess.run([sys.executable, "-c", CHILD, root, str(REPEATS)],
                             capture_output=True, text=True, check=True)
        runs = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{root}: decode step mean "
              + ", ".join(f"{r['mean_s'] * 1e3:.3f}" for r in runs)
              + " ms (cv " + ", ".join(f"{r['cv']:.3f}" for r in runs)
              + "; p99 " + ", ".join(f"{r['p99_s'] * 1e3:.3f}" for r in runs) + " ms)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
