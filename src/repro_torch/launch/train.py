"""Training launcher (``repro/launch/train.py`` in PyTorch)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --steps 6 --batch 2 --seq 1024

trains at full width on the card (bf16 weights, f32 AdamW moments); on
the CPU pass ``--device cpu`` with ``--smoke`` (the reduced config).  Runs
on CUDA unless ``--device cpu`` is given, and fails without a card: it
never moves to the CPU on its own.  One device only: ``--mesh`` takes
``local``; ``single``/``multi`` and ``--fsdp`` wait for sharded training
(ROADMAP.md Queue 1 step 8).  Every arch trains on either device;
on the card the ssm and hybrid archs (``--arch rwkv6-3b``,
``--arch zamba2-2.7b``) run their scans' forward kernels, and the scans'
gradients are those of the reference's chunked forms under autograd.
Weights are random, from a ``torch.Generator`` seeded with 0.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import Model
from repro_torch.train import DataConfig, PrefetchIterator, TrainConfig, Trainer, \
    save_checkpoint, synthetic_batches
from repro_torch.train.optimizer import AdamWConfig


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--mesh", choices=("local", "single", "multi"), default="local")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.mesh != "local":
        ap.error(f"--mesh {args.mesh}: sharded training (ROADMAP.md Queue 1 step 8) is not "
                 "ported yet; the port trains on one device")
    if args.fsdp:
        ap.error("--fsdp: sharded training (ROADMAP.md Queue 1 step 8) is not ported yet")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")

    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg)
    print(f"arch={cfg.name} params={model.num_params()/1e6:.1f}M family={cfg.family}")

    trainer = Trainer(
        model, args.device,
        TrainConfig(
            opt=AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                            total_steps=args.steps),
            grad_accum=args.grad_accum,
        ),
    )
    params, opt_state = trainer.init(0)
    batches = PrefetchIterator(
        synthetic_batches(cfg, DataConfig(batch=args.batch, seq_len=args.seq)))

    def log(i, m):
        print(f"step {i:5d} loss={m['loss']:.4f} lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f}",
              flush=True)

    params, opt_state = trainer.fit(params, opt_state, batches, args.steps, log=log)
    s = trainer.latency_summary()
    print(f"step latency: mean={s.mean*1e3:.1f}ms cv={s.cv:.3f} p99={s.p99*1e3:.1f}ms")
    if args.ckpt:
        print("saved:", save_checkpoint(args.ckpt, args.steps, {"params": params, "opt": opt_state}))


if __name__ == "__main__":
    main()
