#!/usr/bin/env python3
"""The flash backward kernel against its plain version and an f64 oracle,
on the card.

    python3 tools/flash_bwd_oracle.py [--order head-major]

For each shape and seed: the forward kernel's output and log-sum-exp,
then the backward kernel's dq, dk and dv, held against
``ref.flash_attention_bwd_ref`` (the f32 formulas that ``chip_smoke.py``
uses) and against the same formulas in float64.  Prints, per gradient,
how many elements fall outside chip_smoke's band (``TOL`` of the dtype)
against each, the kernel's largest error against the f64 oracle, and the
f32 formulas' own.  Shapes: mixtral-8x22b's 4096 window over 8192 (bf16
and f32, two seeds), qwen3-4b's training shape and internvl2-1b's group
of 7 (bf16).

``--order head-major`` builds a copy of ``csrc/flash_attention_bwd.cu``
in which the dK/dV kernels take a key tile's items head by head, each
head's q tiles nearest (the diagonal tile) first, as the kernels' first
version did, instead of q tile by q tile, farthest first; and runs that:
the accumulation-order experiment of the source's note.  The committed
sources are not changed.  Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import math
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

FA = importlib.import_module("repro_torch.kernels.flash_attention")

CASES = [((1, 8192, 48, 8, 128, True, 4096), torch.bfloat16, (42, 43)),
         ((1, 8192, 48, 8, 128, True, 4096), torch.float32, (42,)),
         ((2, 1024, 32, 8, 128, True, None), torch.bfloat16, (42,)),
         ((4, 1024, 14, 2, 64, True, None), torch.bfloat16, (42,))]
# the lines that set the dK/dV kernels' item order (bf16: item i's q tile
# and head; f32: the two loops), and the head-major, nearest-first order
# that replaces them
HEAD_MAJOR = [("auto item_q0 = [&](int i) { return (qhi - 1 - i / G) * BT; };",
               "auto item_q0 = [&](int i) { return (qlo + i % (qhi - qlo)) * BT; };"),
              ("const int h = kh * G + i % G, q0 = item_q0(i);",
               "const int h = kh * G + i / (qhi - qlo), q0 = item_q0(i);"),
              ("""  for (int qt = qhi - 1; qt >= qlo; --qt) {
    const int q0 = qt * BT;
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;""",
               """  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int qt = qlo; qt < qhi; ++qt) {
      const int q0 = qt * BT;""")]


def head_major_kernel():
    """The backward library built from a copy whose dK/dV kernels take
    their items head by head, nearest q tile first; its
    flash_attention_bwd entry point."""
    build = _build.BUILD_DIR / "oracle_head_major"
    shutil.rmtree(build, ignore_errors=True)
    shutil.copytree(_build.CSRC, build)
    src = build / "flash_attention_bwd.cu"
    text = src.read_text()
    for old, new in HEAD_MAJOR:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once in flash_attention_bwd.cu: {old}")
        text = text.replace(old, new)
    src.write_text(text)
    lib = build / "flash_attention_bwd.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(build), "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bwd_f64(q, k, v, o, do, causal, window):
    """ref.flash_attention_bwd_ref's formulas in float64."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    allow = R.attention_mask(pos, pos, causal, window)
    dqs, dks, dvs = [], [], []
    for j in range(k.shape[2]):
        heads = slice(j * g, (j + 1) * g)
        qj, oj, doj = (t[:, :, heads].double() for t in (q, o, do))
        kj, vj = k[:, :, j].double(), v[:, :, j].double()
        p = torch.softmax((torch.einsum("bqgd,btd->bgqt", qj, kj) * scale)
                          .masked_fill(~allow, R.NEG_INF), -1)
        dvs.append(torch.einsum("bgqt,bqgd->btd", p, doj))
        ds = p * (torch.einsum("bqgd,btd->bgqt", doj, vj)
                  - (doj * oj).sum(-1).transpose(1, 2)[..., None])
        del p
        dqs.append(torch.einsum("bgqt,btd->bqgd", ds, kj) * scale)
        dks.append(torch.einsum("bgqt,bqgd->btd", ds, qj) * scale)
    return torch.cat(dqs, 2), torch.stack(dks, 2), torch.stack(dvs, 2)


def out_of_band(got, want, dtype) -> int:
    tol = C.TOL[dtype]
    return int(((got.double() - want).abs() > tol["atol"] + tol["rtol"] * want.abs()).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--order", choices=("far-first", "head-major"), default="far-first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_oracle: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    if args.order == "head-major":
        FA._bwd_fn = head_major_kernel()
    print(f"{torch.cuda.get_device_name(0)}; dK/dV item order: {args.order}", flush=True)
    for (b, s, h, k, d, causal, window), dtype, seeds in CASES:
        for seed in seeds:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            q, kk, v, do = (C.randn(gen, shp, dtype, dev)
                            for shp in ((b, s, h, d), (b, s, k, d), (b, s, k, d), (b, s, h, d)))
            lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
            o = FA.flash_attention_cuda(q, kk, v, causal, window, lse=lse)
            got = FA.flash_attention_bwd_cuda(q, kk, v, o, do, lse, causal, window)
            want = R.flash_attention_bwd_ref(*C.f32(q, kk, v, o, do), causal, window)
            exact = bwd_f64(q, kk, v, o, do, causal, window)
            for name, g_, w, e in zip(("dq", "dk", "dv"), got, want, exact):
                print(f"{(b, s, h, k, d)} causal {causal} window {window} {str(dtype)[6:]} seed "
                      f"{seed} {name}: out of band vs f32 formulas {out_of_band(g_, w.double(), dtype)}"
                      f", vs f64 {out_of_band(g_, e, dtype)}; max |kernel - f64| "
                      f"{(g_.double() - e).abs().max().item():.3e}, max |f32 formulas - f64| "
                      f"{(w.double() - e).abs().max().item():.3e}", flush=True)
            del q, kk, v, do, o, got, want, exact
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
