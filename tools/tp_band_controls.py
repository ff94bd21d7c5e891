#!/usr/bin/env python3
"""Controls for ``chip_smoke.py``'s ``SHARD_BAND`` under tensor-parallel
training, on the card.

    python3 tools/tp_band_controls.py [--arch qwen3-4b|rwkv6-3b|zamba2-2.7b]

First the decode kernel's row log-sum-exp against its plain version
(``chip_smoke.tp_lse_kernel``).  Then one of
phase 10b's training cuts (qwen3-4b at ``SHARD_LAYERS`` layers, or
rwkv6-3b / zamba2-2.7b at ``TP_TRAIN_CUTS``' depth; data=1 x model=2, two
ranks on the one card over gloo) against one rank of the same cut, in one
spawned group, once per variant:

- ``committed``: the sources as they are (the row-parallel partial sums,
  each a bf16 product, summed over ``model`` in f32);
- ``bf16 reduction``: the sums over ``model`` taken in the partials' own
  dtype;
- ``f32 partials`` (qwen3-4b): the row-parallel products (attention's
  output projection, the MLP's down projection) written in f32 and summed
  in f32, rounded to bf16 once, as one product over the whole K rounds;
- ``f32 model`` (rwkv6-3b, zamba2-2.7b): the cut with f32 weights and
  activations, against one rank of it in f32;
- ``unreduced``: each rank keeps its own partial sums (a negative control;
  for rwkv6-3b and zamba2-2.7b those of the RWKV6 and Mamba2 blocks).

Prints each step's loss against the one rank's, relative, and whether it
falls inside ``SHARD_BAND``.  The variants replace functions in the
spawned ranks only; the committed sources are not changed.

With ``--serve`` (rwkv6-3b, zamba2-2.7b) it runs phase 10b's serving of
the arch instead (whole, data=1 x model=2, the phase's prompt and tokens),
in bf16 and in f32, each against one rank in the same dtype: the prefill's
and the decode steps' largest logit difference over the largest logit,
against ``SERVE_BAND``, and the tokens as ``_serve_ties`` judges them.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import tp  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.models import attention, layers, mamba2, rwkv6  # noqa: E402

COMMITTED = (tp.ModelParallel.all_reduce, attention.leave, layers.mlp, attention._out_proj,
             rwkv6.leave, mamba2.leave)


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


FAULTS = {"qwen3-4b": ("committed", "bf16 reduction", "f32 partials", "unreduced"),
          "rwkv6-3b": ("committed", "bf16 reduction", "f32 model", "unreduced"),
          "zamba2-2.7b": ("committed", "bf16 reduction", "f32 model", "unreduced")}
F32 = dict(param_dtype="float32", dtype="float32")


def _apply(fault: str) -> None:
    """Install ``fault``'s functions (module docstring); the MLP's
    replacement serves only the gated MLP of the dense cut."""
    (tp.ModelParallel.all_reduce, attention.leave, layers.mlp, attention._out_proj,
     rwkv6.leave, mamba2.leave) = COMMITTED
    if fault == "bf16 reduction":
        tp.ModelParallel.all_reduce = reduce_in_own_dtype
    elif fault == "unreduced":
        attention.leave = lambda x, tp_: x
        layers.mlp = lambda p, x, tp_=None: _mlp(p, x, tp_, False, False)
        rwkv6.leave = mamba2.leave = lambda x, tp_: x
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


def serve(arch: str, dev, smi: str) -> int:
    """Phase 10b's serving of ``arch`` in bf16 and in f32 against one rank
    (module docstring)."""
    rng = np.random.default_rng(5)
    for name, cut in C.TP_SERVE.items():        # the phase's draws, in its order
        tokens = rng.integers(0, get_config(name).vocab_size, (1, C.TP_PREFILL)).astype(np.int32)
        if name == arch:
            break
    prompt = C.TP_SERVE[arch].get("prompt", C.TP_PROMPT)
    refs, jobs = {}, []
    for dtype, kw in (("bf16", {}), ("f32", F32)):
        cfg = get_config(arch).replace(**kw)
        refs[dtype] = C._one_rank_serve(dev, cfg, tokens, prompt)
        jobs.append(dict(kind="tp_serve", cfg=cfg, mesh=dict(data=1, model=2), tokens=tokens,
                         prompt=prompt, force=refs[dtype]["tokens"], context=C.TP_CONTEXT))
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        ranks = run_ranks(C._sharded_ranks, 2, init_file=str(Path(d) / "pg"), backend="gloo",
                          args=(jobs, [str(dev)] * 2), timeout=900)
    for j, dtype in enumerate(refs):
        ref = refs[dtype]
        for r in range(2):
            w = ranks[r][j]
            pre = C._rel(w["prefill"], ref["prefill"])
            step = max(C._rel(a, b) for a, b in zip(w["logits"], ref["logits"]))
            clear, ties = C._serve_ties(w, ref)
            print(f"({smi}) {arch} {dtype} served at data=1 x model=2, rank {r}: logits within "
                  f"{pre:.3e} (prefill), {step:.3e} (decode) of the largest, "
                  f"{'inside' if max(pre, step) <= C.SERVE_BAND else 'outside'} SERVE_BAND "
                  f"{C.SERVE_BAND}; tokens equal at the {clear} of {len(ref['tokens'])} steps "
                  f"with a clear margin, ties {ties}; token {w['token_ms']:.3f} ms (one rank "
                  f"{ref['token_ms']:.3f})", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=sorted(FAULTS))
    ap.add_argument("--serve", action="store_true",
                    help="phase 10b's serving of --arch in bf16 and f32 (rwkv6-3b, zamba2-2.7b)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_band_controls: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    C.tp_lse_kernel(dev, f"({smi})")
    if args.serve:
        return serve(args.arch, dev, smi)
    faults = FAULTS[args.arch]
    layers_ = C.TP_TRAIN_CUTS.get(args.arch, C.SHARD_LAYERS)
    ones = {}
    for dtype, kw in (("bf16", {}), ("f32", F32)):
        if dtype == "bf16" or "f32 model" in faults:
            model, opt, one, *_ = C.one_rank_width(dev, args.arch, layers_, **kw)
            ones[dtype] = (model, one)
            print(f"({smi}) one rank, {args.arch} {layers_} layers {dtype}, {C.SHARD_B} x "
                  f"{C.SHARD_S}: losses {[m['loss'] for m in one]}", flush=True)
            torch.cuda.empty_cache()
    jobs = [dict(kind="width", cfg=ones["f32" if f == "f32 model" else "bf16"][0].cfg, opt=opt,
                 mesh=dict(data=1, model=2), fsdp=False, batch=C.SHARD_B, seq=C.SHARD_S,
                 steps=C.SHARD_STEPS, fault=f) for f in faults]
    with tempfile.TemporaryDirectory() as d:
        ranks = run_ranks(_control_ranks, 2, init_file=str(Path(d) / "pg"), backend="gloo",
                          args=(jobs, [str(dev)] * 2), timeout=900)
    for j, name in enumerate(faults):
        one = ones["f32" if name == "f32 model" else "bf16"][1]
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
