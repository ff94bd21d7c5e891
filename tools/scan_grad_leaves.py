#!/usr/bin/env python3
"""The scans' backward kernels inside the full-width training step, leaf by
leaf, on the card.

    python3 tools/scan_grad_leaves.py [--arch rwkv6-3b zamba2-2.7b] [--steps 6] [--at 0 4] [--calls]
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

At each step of ``--at`` (the weights ``plain``, or the variant
``--weights`` names, reaches after that many steps from the init, and
that step's batch): every gradient leaf under
``kernel`` and the controls against ``plain``: ||g - g_plain|| /
||g_plain|| and max |g - g_plain| / max |g_plain|, one line a leaf (a leaf
stacks its layers).  With ``--calls``, the ``kernel`` variant's gradients
at those steps also check each backward call on its own inputs: the kernel
again (equal bits?) and the plain version and the controls, each output's
||diff|| / ||plain|| (one line per scan and output: the kernel's largest,
the largest kernel / nearer control over the calls, and that call's
number, the backward running the last layer first).  Then each variant trains ``--steps`` steps from the same init
through ``Trainer.fit`` and prints its losses, each against ``plain``'s,
and its gradient norms.
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


def use_checked(calls: list) -> None:
    """The ``kernel`` variant, each call also run again and beside the plain
    version at the chunk and its controls at a half and a quarter of it,
    on the same inputs; appends (scan, bits equal, {output: (kernel,
    plain/2, plain/4) ||diff|| / ||plain||}) to ``calls``."""
    wkv, ssd = COMMITTED

    def record(scan, got, again, plains, names):
        ratio = {}
        for i, n in enumerate(names):
            want = plains[0][i].double()
            ratio[n] = tuple(((x.double() - want).norm() / want.norm()).item()
                             for x in [got[i]] + [p[i] for p in plains[1:]])
        calls.append((scan, all(torch.equal(g, a) for g, a in zip(got, again)), ratio))

    def wkv_checked(r, k, v, logw, u, dy, grad_chunk):
        got, again = (wkv(r, k, v, logw, u, dy, grad_chunk) for _ in range(2))
        plains = [W.wkv_chunked_grads((r, k, v, logw, u), grad_chunk // f, dy) for f in (1, 2, 4)]
        record("rwkv6_wkv_bwd", got, again, plains, ("dr", "dk", "dv", "dlogw", "du"))
        return got

    def ssd_checked(x, dt, a, bm, cm, dy, chunk, hb):
        got, again = (ssd(x, dt, a, bm, cm, dy, chunk, hb) for _ in range(2))
        plains = [M.ssd_chunked_grads((x, dt, a, bm, cm), chunk // f, dy) for f in (1, 2, 4)]
        record("mamba2_ssd_bwd", got, again, plains, ("dx", "ddt", "da", "dB", "dC"))
        return got

    # the wrappers count their launches on the module's name, now these
    wkv_checked.launches = ssd_checked.launches = 0
    W.rwkv6_wkv_bwd_cuda, M.mamba2_ssd_bwd_cuda = wkv_checked, ssd_checked


def report_calls(arch: str, at: int, calls: list) -> None:
    """One line per scan and output of ``use_checked``'s records, the calls
    numbered in the order the backward ran them (the last layer first)."""
    for scan in dict.fromkeys(c[0] for c in calls):
        mine = [c for c in calls if c[0] == scan]
        for out in mine[0][2]:
            # calls where a control equals the plain version's bits have no ratio
            ratios = {i: c[2][out][0] / min(c[2][out][1:]) for i, c in enumerate(mine)
                      if min(c[2][out][1:]) > 0}
            head = (f"[{arch}] step {at} calls {scan} {out}: kernel largest "
                    f"{max(c[2][out][0] for c in mine):.3e}")
            if not ratios:
                print(f"{head}; every call's controls equal the plain version", flush=True)
                continue
            worst = max(ratios, key=ratios.get)
            k, c2, c4 = mine[worst][2][out]
            big = max(range(len(mine)), key=lambda i: mine[i][2][out][0])
            print(f"{head} (call {big}: controls "
                  + ", ".join(f"{x:.3e}" for x in mine[big][2][out][1:])
                  + f"); largest kernel / nearer control {ratios[worst]:.3f} (call {worst} of "
                  f"{len(mine)}: kernel {k:.3e}, plain/2 {c2:.3e}, plain/4 {c4:.3e}; "
                  f"{len(mine) - len(ratios)} calls without a ratio)", flush=True)
        print(f"[{arch}] step {at} calls {scan}: {len(mine)} calls, the kernel's bits equal on "
              f"a second run in {sum(c[1] for c in mine)}", flush=True)


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


def train(trainer, model, data, steps: int) -> tuple[dict, list[tuple[float, float]]]:
    """The weights after ``steps`` steps from the init, and each step's
    loss and gradient norm."""
    params, opt_state = trainer.init(0)
    out = []
    if steps:
        params, _ = trainer.fit(params, opt_state, PrefetchIterator(
            synthetic_batches(model.cfg, data)), steps,
            log=lambda i, m: out.append((m["loss"], m["grad_norm"])))
    return params, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=["rwkv6-3b", "zamba2-2.7b"])
    ap.add_argument("--steps", type=int, default=C.TRAIN_STEPS)
    ap.add_argument("--at", type=int, nargs="+", default=[0, 4])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="reduced_for_smoke width, 2 x 64 tokens")
    ap.add_argument("--weights", default="plain", choices=VARIANTS,
                    help="the variant whose training reaches the weights of each --at step")
    ap.add_argument("--calls", action="store_true",
                    help="check each backward call of the kernel variant's gradients")
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
            use(args.weights)
            params, _ = train(trainer, model, data, at)
            use("plain")
            ref_loss, names, ref = grads_at(model, params, data, at, dev)
            norm = lambda gs: sum(g.float().norm() ** 2 for g in gs).sqrt().item()  # noqa: E731
            ref_norm = norm(ref)
            rows[at] = {n: {} for n in names}
            for variant in VARIANTS[1:]:
                calls = []
                use(variant)
                if variant == "kernel" and args.calls:
                    use_checked(calls)
                loss, _, grads = grads_at(model, params, data, at, dev)
                report_calls(arch, at, calls)
                print(f"[{arch}] step {at} {variant}: loss {loss:.6f} (plain {ref_loss:.6f}), "
                      f"gradient norm {norm(grads):.4f} (plain {ref_norm:.4f})", flush=True)
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
            losses = [x for x, _ in traj[variant]]
            line = " ".join(f"{x:.6f}" for x in losses)
            rel = " ".join(f"{abs(x - p) / abs(p):.2e}" for x, (p, _) in zip(losses,
                                                                              traj["plain"]))
            print(f"[{arch}] {variant:8s} losses {line}; |diff| / plain {rel}; gradient norms "
                  + " ".join(f"{g:.4f}" for _, g in traj[variant]), flush=True)
        use("kernel")
        del model, trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
