"""Training launcher (``repro/launch/train.py`` in PyTorch)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --steps 6 --batch 2 --seq 1024

trains at full width on the card (bf16 weights, f32 AdamW moments); on
the CPU pass ``--device cpu`` with ``--smoke`` (the reduced config).  Runs
on CUDA unless ``--device cpu`` is given, and fails without a card: it
never moves to the CPU on its own.  ``--mesh local`` (the default) is one
device, a 1 x 1 training mesh with ``--fsdp``; ``--mesh single|multi`` is
the production mesh, (data=16, model=16) or (pod=2, data=16, model=16),
over a process group of 256 or 512 ranks started by ``torchrun`` (NCCL on
the cards, rank r on ``cuda:LOCAL_RANK``; gloo with ``--device cpu``)::

    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
        --arch olmoe-1b-7b --mesh single --fsdp

and exits naming the ranks it needs in a world of another size.  Other
mesh shapes go through ``Trainer(model, make_train_mesh(...))``.  Rank 0
prints and writes the checkpoint.  Every arch trains on either device;
on the card the ssm and hybrid archs (``--arch rwkv6-3b``,
``--arch zamba2-2.7b``) run their scans' forward and backward kernels.
Weights are random, from a ``torch.Generator`` seeded with 0.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh, make_train_mesh
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
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    device = args.device
    if args.mesh == "local":
        target = make_train_mesh(device=device) if args.fsdp else device
    else:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:     # started by torchrun
            if torch.device(device).type == "cuda":
                device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
                torch.cuda.set_device(device)
            dist.init_process_group("nccl" if torch.device(device).type == "cuda" else "gloo")
        try:
            target = make_production_mesh(multi_pod=args.mesh == "multi", device=device)
        except ValueError as e:
            ap.error(f"--mesh {args.mesh}: {e}")
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg)
    say(f"arch={cfg.name} params={model.num_params()/1e6:.1f}M family={cfg.family}")

    trainer = Trainer(
        model, target,
        TrainConfig(
            opt=AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                            total_steps=args.steps),
            grad_accum=args.grad_accum,
        ),
        fsdp=args.fsdp,
    )
    params, opt_state = trainer.init(0)
    batches = PrefetchIterator(
        synthetic_batches(cfg, DataConfig(batch=args.batch, seq_len=args.seq)))

    def log(i, m):
        say(f"step {i:5d} loss={m['loss']:.4f} lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f}",
              flush=True)

    params, opt_state = trainer.fit(params, opt_state, batches, args.steps, log=log)
    s = trainer.latency_summary()
    say(f"step latency: mean={s.mean*1e3:.1f}ms cv={s.cv:.3f} p99={s.p99*1e3:.1f}ms")
    if args.ckpt:
        sharding = trainer.state_sharding() if trainer.mesh is not None else None
        say("saved:", save_checkpoint(args.ckpt, args.steps, {"params": params, "opt": opt_state},
                                      sharding=sharding))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
