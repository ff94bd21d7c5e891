#!/usr/bin/env python3
"""The scans' backward kernels inside the full-width training step, leaf by
leaf, on the card.

    python3 tools/scan_grad_leaves.py [--arch rwkv6-3b zamba2-2.7b] [--steps 6] [--at 0 4]
    python3 tools/scan_grad_leaves.py --smoke --device cpu   # the script itself, small

For each arch, chip_smoke's training path (full width and depth in bf16,
remat on, TRAIN_B x TRAIN_S tokens of make_batch_np, init seed 0, AdamW at
TRAIN_LR) runs three ways; the committed sources are not changed, the
variants replace the backward wrapper in this process only:

- ``kernel``: the scan's backward kernel, as the path runs it;
- ``plain``: its plain version on the card (``wkv_chunked_grads`` /
  ``ssd_chunked_grads``: the chunked form at the model's chunk under
  autograd, f32);
- ``plain/2``, ``plain/4``: the plain version at a half and a quarter of
  that chunk.  The chunk changes only the rounding, so these are the same
  gradient rounded other ways in f32: controls for what rounding alone
  does downstream.

At each step of ``--at`` (the weights ``plain`` reaches after that many
steps from the init, and that step's batch): every gradient leaf under
``kernel`` and the controls against ``plain``: ||g - g_plain|| /
||g_plain|| and max |g - g_plain| / max |g_plain|, one line a leaf (a leaf
stacks its layers).  Then each variant trains ``--steps`` steps from the
same init through ``Trainer.fit`` and prints its losses, each against
``plain``'s.
The card's name and power limit head the output.
"""
from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as C  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import (AdamWConfig, DataConfig, PrefetchIterator,  # noqa: E402
                               TrainConfig, Trainer, make_batch_np, synthetic_batches)
from repro_torch.train.data import to_device  # noqa: E402
from repro_torch.train.optimizer import _walk  # noqa: E402

# the modules (``repro_torch.kernels`` exports functions of the same names)
M = importlib.import_module("repro_torch.kernels.mamba2_ssd")
W = importlib.import_module("repro_torch.kernels.rwkv6_scan")
COMMITTED = (W.rwkv6_wkv_bwd_cuda, M.mamba2_ssd_bwd_cuda)
VARIANTS = ("plain", "kernel", "plain/2", "plain/4")


def use(variant: str) -> None:
    """Route both scans' backward through ``variant``."""
    W.rwkv6_wkv_bwd_cuda, M.mamba2_ssd_bwd_cuda = COMMITTED
    if variant == "kernel":
        return
    f = 1 if variant == "plain" else int(variant.split("/")[1])
    W.rwkv6_wkv_bwd_cuda = lambda r, k, v, logw, u, dy, grad_chunk: W.wkv_chunked_grads(
        (r, k, v, logw, u), grad_chunk // f, dy)
    M.mamba2_ssd_bwd_cuda = lambda x, dt, a, bm, cm, dy, chunk, hb: M.ssd_chunked_grads(
        (x, dt, a, bm, cm), chunk // f, dy)


def setup(arch: str, dev, smoke: bool):
    cfg = get_config(arch)
    cfg = reduced_for_smoke(cfg) if smoke else cfg
    b, s = (2, 64) if smoke else (C.TRAIN_B, C.TRAIN_S)
    opt = AdamWConfig(lr=C.TRAIN_LR, warmup_steps=min(20, C.TRAIN_STEPS // 5 + 1),
                      total_steps=C.TRAIN_STEPS)
    model = Model(cfg)
    return model, Trainer(model, dev, TrainConfig(opt=opt, log_every=1)), DataConfig(batch=b,
                                                                                  seq_len=s)


def grads_at(model, params, data, step: int, dev) -> tuple[float, list, list]:
    """Batch ``step``'s loss and every leaf's gradient at ``params``, as
    the train step takes them (``grads_of``)."""
    batch = to_device(make_batch_np(model.cfg, data, step), dev)
    walked = list(_walk(params))
    with torch.enable_grad():
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, [t for _, t in walked])
    return loss.item(), [".".join(map(str, k)) for k, _ in walked], list(grads)


def train(trainer, model, data, steps: int) -> tuple[dict, list[float]]:
    """The weights after ``steps`` steps from the init, and the losses."""
    params, opt_state = trainer.init(0)
    out = []
    if steps:
        params, _ = trainer.fit(params, opt_state, PrefetchIterator(
            synthetic_batches(model.cfg, data)), steps, log=lambda i, m: out.append(m["loss"]))
    return params, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=["rwkv6-3b", "zamba2-2.7b"])
    ap.add_argument("--steps", type=int, default=C.TRAIN_STEPS)
    ap.add_argument("--at", type=int, nargs="+", default=[0, 4])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="reduced_for_smoke width, 2 x 64 tokens")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        C.phase_build()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    for arch in args.arch:
        model, trainer, data = setup(arch, dev, args.smoke)
        rows = {}
        for at in args.at:
            use("plain")
            params, _ = train(trainer, model, data, at)
            ref_loss, names, ref = grads_at(model, params, data, at, dev)
            rows[at] = {n: {} for n in names}
            for variant in VARIANTS[1:]:
                use(variant)
                loss, _, grads = grads_at(model, params, data, at, dev)
                print(f"[{arch}] step {at} {variant}: loss {loss:.6f} (plain {ref_loss:.6f})",
                      flush=True)
                for n, g, w in zip(names, grads, ref):
                    d, w = g.float() - w.float(), w.float()
                    rows[at][n][variant] = dict(norm=(d.norm() / w.norm()).item(),
                                                max=(d.abs().max() / w.abs().max()).item())
                del grads
            del ref, params
            print(f"[{arch}] step {at}, each leaf against plain: ||diff|| / ||plain||, "
                  f"max |diff| / max |plain| ({'; '.join(VARIANTS[1:])})", flush=True)
            for n in names:
                cells = "; ".join(f"{rows[at][n][v]['norm']:.3e} {rows[at][n][v]['max']:.3e}"
                                  for v in VARIANTS[1:])
                print(f"  {n:32s} {cells}", flush=True)
            ratio = max(rows[at][n]["kernel"]["norm"]
                        / max(min(rows[at][n][v]["norm"] for v in VARIANTS[2:]), 1e-30)
                        for n in names if rows[at][n]["kernel"]["norm"] > 0)
            worst = {v: max(names, key=lambda n: rows[at][n][v]["norm"]) for v in VARIANTS[1:]}
            print(f"[{arch}] step {at} worst leaf by norm: " + "; ".join(
                f"{v} {worst[v]} {rows[at][worst[v]][v]['norm']:.3e}" for v in VARIANTS[1:])
                + f"; largest kernel / nearest control over the leaves {ratio:.3f}", flush=True)
        traj = {}
        for variant in VARIANTS:
            use(variant)
            traj[variant] = train(trainer, model, data, args.steps)[1]
        for variant in VARIANTS:
            line = " ".join(f"{x:.6f}" for x in traj[variant])
            rel = " ".join(f"{abs(x - p) / abs(p):.2e}" for x, p in zip(traj[variant],
                                                                         traj["plain"]))
            print(f"[{arch}] {variant:8s} losses {line}; |diff| / plain {rel}", flush=True)
        use("kernel")
        del model, trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
