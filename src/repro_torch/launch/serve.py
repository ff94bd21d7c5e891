"""Serving launcher: single-stream instrumented decoding on the card::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --batch 4 --context 1024 --prompt-len 64 --tokens 32

(``--arch`` takes every ported arch: qwen3-4b, rwkv6-3b, zamba2-2.7b.)

Runs on CUDA unless ``--device cpu`` is given (a CPU run is for checking
control flow at ``--smoke`` size; its times are not the card's).
Weights are random, from a ``torch.Generator`` seeded with 0.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.deadline import KalmanDeadline, MeanDeadline, PercentileDeadline, \
    WorstObserved
from repro_torch.models import Model
from repro_torch.runtime import Engine, ServeConfig

POLICY = {
    "worst": WorstObserved,
    "mean": lambda: MeanDeadline(margin=1.5),
    "p95": lambda: PercentileDeadline(q=95.0),
    "kalman": KalmanDeadline,
}


def serve_single(args, cfg, model, params) -> None:
    eng = Engine(
        model,
        ServeConfig(batch=args.batch, context=args.context),
        deadline_policy=POLICY[args.deadline](),
        device=args.device,
    )
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    out, rec = eng.generate(params, prompt, max_new_tokens=args.tokens)
    print(f"generated {out.shape} tokens; first row: {out[0, :12]}")
    rep = eng.report()
    print("serving report:",
          " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in rep.items()))
    for row in rec.breakdown_table():
        print(f"  {row['stage']:>16s}: mean={row['mean']*1e3:7.3f}ms cv={row['cv']:.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--deadline", choices=sorted(POLICY), default="mean")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg)
    params = model.init(seed=0, device=args.device)
    print(f"arch={cfg.name} params={model.num_params()/1e6:.1f}M device={args.device}")
    serve_single(args, cfg, model, params)


if __name__ == "__main__":
    main()
