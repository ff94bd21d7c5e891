#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Three serving paths at full width, four hand-written kernels: qwen3-4b
(dense: flash_attention, decode_attention), rwkv6-3b (ssm: rwkv6_wkv) and
zamba2-2.7b (hybrid: mamba2_ssd, and flash/decode attention at head_dim 80
in the shared block).  bf16 flash runs the wgmma/TMA kernel, f32 flash the
FMA kernel; decode is one launch per call; each scan call launches two
kernels (the shared scores, then the scan) on the tensor cores in split
TF32, and counts as one call.

Phases (each raises on failure; none is caught):

1. build   — compile every kernel in src/repro_torch/kernels/csrc with nvcc,
             one process per source, all at once;
2. kernels — each hand-written kernel against its plain PyTorch version on
             the card.  Attention: the reference's test sweep shapes
             (tests/test_kernels.py, ring-buffer wraparound included) and
             the full-width qwen3-4b (head_dim 128) and zamba2-2.7b
             (head_dim 80) shapes, at float32 and bfloat16, each held
             against its plain version run in float32 on the same inputs
             (tolerances at TOL).  Scans: the reference's sweeps
             (tests/test_kernels.py:96-180, logw = -25 included), ragged
             and odd lengths (S = 37, 96, 100) at head widths and state
             sizes of 16, 32 and 64, and the full-width shapes, rwkv6 at
             (4,1024,40,64) chunk 64 with decay strength 0.5 and 6.0 and
             logw = -25, mamba2 at x (4,1024,80,64), N 64, chunk 256,
             head_block 8; f32 at the reference's 2e-4, the full-width
             errors printed.  TF32 off (the scans' own split TF32 is
             written in their kernels);
3. model   — for each arch: the port's CUDA path against its CPU path on
             the smoke model (f32, 1e-3: cuBLAS and CPU sum in different
             orders); then the arch's main path at full width in bf16 with
             seeded random weights: Model.prefill on 4 x 1024 tokens and
             Engine.generate answering 4 requests (context 1024, prompt 64,
             32 new tokens), with the kernels' launch counters reset just
             before and read just after, and each counter held to the
             launches that path must make (PATHS); then prefill against
             token-by-token decode on one prompt (128 tokens; 256 for
             zamba2, whose prefill needs whole 256-row SSD chunks);
4. times   — per arch: Model.prefill wall time and the device time by
             kernel for a prefill and for decode steps (torch.profiler)
             with the device's busy share; each kernel, its plain version
             and, for attention, the PyTorch library call
             (scaled_dot_product_attention, with |sdpa - kernel|) at the
             full-width shapes, device time only (calls captured in a CUDA
             graph, replayed between CUDA events; for attention the median
             of ROUNDS rounds, kernel and SDPA alternating, with the range
             printed; the scans as medians of ROUNDS rounds too); the bound
             from the shapes and the H100's peaks.  No single PyTorch call
             computes either scan, so their library_ms is null.

The build phase prints each kernel's registers, static shared memory and
spill bytes from the compiler's -Xptxas -v report, and the scan kernels'
blocks per SM from the occupancy API.  Prints the card's name
and power limit, one ``{"kernels": [...]}`` line (each row also names the
kernel's design), and as the last line ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result, when there is no CUDA device or no
``src/repro_torch`` beside it.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate and tensor-core /
# CUDA-core rates by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
# the scans multiply in split TF32: three tensor-core passes per product
TF32_PASSES = 3
# Both kernels compute in f32 (bf16 flash: products of bf16 values summed in
# f32, and P carried as bf16 hi + lo, within 2**-16 of p) and round the
# output to q's dtype once, so each is held against its plain version
# computed in f32 on the same inputs.
# f32: the reference sweep's 2e-5 (tests/test_kernels.py:23; the two sum in
# different orders).  bf16: the one rounding, at most half a bf16 ulp, which
# is 2**-8 of the value (rtol 4e-3), on top of the same f32 differences.
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5), torch.bfloat16: dict(atol=2e-5, rtol=4e-3)}
# The scans take and return f32; held against the step recurrences at the
# reference sweep's 2e-4 (tests/test_kernels.py:96-180).
SCAN_TOL = dict(atol=2e-4, rtol=2e-4)

# the reference's kernel sweeps (tests/test_kernels.py:27-92)
FLASH_SWEEP = [(1, 128, 4, 4, 32), (2, 256, 4, 2, 32), (1, 128, 8, 1, 64)]
DECODE_SWEEP = [(2, 4, 2, 32, 256), (1, 8, 1, 64, 128), (2, 4, 4, 32, 128)]

RWKV_SWEEP = [(1, 64, 2, 16), (2, 128, 3, 32), (1, 128, 1, 64)]      # (b, s, h, dk)
MAMBA_SWEEP = [(1, 64, 4, 16, 16), (2, 128, 8, 16, 24)]              # (b, s, h, p, n)

# full-width serving shapes: batch, prefill, context, prompt, new tokens
B, S_PREFILL, CONTEXT, PROMPT, NEW_TOKENS = 4, 1024, 1024, 64, 32
H, KV, D = 32, 8, 128                 # qwen3-4b attention
ZH, ZKV, ZD = 32, 32, 80              # zamba2-2.7b shared-block attention
RWKV_FULL = (B, S_PREFILL, 40, 64)    # rwkv6-3b scan: (b, s, heads, dk), chunk 64
MAMBA_FULL = (B, S_PREFILL, 80, 64, 64)  # zamba2-2.7b scan: (b, s, heads, P, N)
RWKV_CHUNK, MAMBA_CHUNK, MAMBA_HB = 64, 256, 8

# Each path's launches: per prefill, and per decode step of Engine.generate
# (one per layer or per site of the shared attention block), and the
# length of its prefill-versus-decode check.
PATHS = {
    "qwen3-4b": dict(prefill={"flash_attention": 36}, step={"decode_attention": 36}, agree=128),
    "rwkv6-3b": dict(prefill={"rwkv6_wkv": 32}, step={}, agree=128),
    "zamba2-2.7b": dict(prefill={"mamba2_ssd": 54, "flash_attention": 9},
                        step={"decode_attention": 9}, agree=256),
}


KERNELS = ("flash_attention", "decode_attention", "rwkv6_wkv", "mamba2_ssd")
SOURCES = {"flash_attention": ("flash_attention.cu", "flash_attention.py:85"),
           "decode_attention": ("decode_attention.cu", "decode_attention.py:75"),
           "rwkv6_wkv": ("rwkv6_scan.cu", "rwkv6_scan.py:109"),
           "mamba2_ssd": ("mamba2_ssd.cu", "mamba2_ssd.py:66")}
# Each kernel's design
DESIGNS = {"flash_attention": {"bfloat16": "wgmma+tma", "float32": "fma"},
           "decode_attention": "cp.async ring + cluster merge",
           "rwkv6_wkv": "scores pre-pass + mma.sync split tf32, 16-row sub-blocks, "
                        "cp.async double buffer",
           "mamba2_ssd": "C.B^T pre-pass + mma.sync split tf32, cp.async double buffer"}
# Kernel times are medians of ROUNDS timings; for attention each kernel
# round is followed by one of SDPA, so the two see the same state of the card.
ROUNDS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype,
            tol: dict | None = None) -> float:
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = tol or TOL[dtype]
    bad = err > tol["atol"] + tol["rtol"] * w.abs()
    if not torch.isfinite(g).all() or bad.any():
        raise AssertionError(f"kernel disagrees with its plain version: max |err| "
                             f"{err.max().item():.3e} ({int(bad.sum())} elements out of tolerance)")
    return err.max().item()


def capture(fn, iters: int) -> torch.cuda.CUDAGraph:
    """``iters`` calls of ``fn`` captured in one CUDA graph (after three
    warm-up calls on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    return graph


def replay_ms(graph: torch.cuda.CUDAGraph, iters: int, replays: int = 5) -> float:
    """Mean device milliseconds per captured call over ``replays`` replays
    between CUDA events, so the host's launch cost is not in the time."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA-graph replays)."""
    return replay_ms(capture(fn, iters), iters, replays)


def rounds_ms(kernel, library, iters: int) -> tuple[list[float], list[float]]:
    """``ROUNDS`` timings each of ``kernel`` and ``library``, alternating."""
    gk, gl = capture(kernel, iters), capture(library, iters)
    ks, ls = [], []
    for _ in range(ROUNDS):
        ks.append(replay_ms(gk, iters))
        ls.append(replay_ms(gl, iters))
    return ks, ls


def spread(xs: list[float]) -> str:
    return f"median {statistics.median(xs):.4f} ms, range {min(xs):.4f}-{max(xs):.4f}"

def randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)


def f32(*xs):
    return [x.float() for x in xs]


def phase_build():
    from repro_torch.kernels import _build as build

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {len(libs)} kernels in {time.perf_counter() - t0:.3f}s: "
        + ", ".join(p.name for p in libs.values()))
    for name in libs:
        for r in build.ptxas_report(name):
            log(f"[build]   {r['kernel']}: {r['registers']} registers, "
                f"{r['smem_bytes']} B static smem, spill {r['spill_stores']}/{r['spill_loads']} B "
                f"(stores/loads)")
    import importlib
    for name in ("mamba2_ssd", "rwkv6_scan"):
        occ = importlib.import_module(f"repro_torch.kernels.{name}").occupancy()
        log(f"[build]   {name} scan kernel: {occ['blocks_per_sm']} blocks per SM (occupancy "
            f"API) of {occ['threads']} threads and {occ['smem_bytes']} B dynamic smem")


def phase_kernels(dev):
    """Each kernel against its plain version; returns the largest
    full-width error of each: bf16 for attention (the main path's dtype),
    f32 for the scans (their only dtype)."""
    from repro_torch import kernels as K
    from repro_torch.kernels import ref as R

    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    full = {}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for (b, s, h, k, d) in FLASH_SWEEP + [(B, S_PREFILL, H, KV, D),
                                              (B, S_PREFILL, ZH, ZKV, ZD)]:
            for causal in (True, False):
                for window in (None, 96):
                    if s == S_PREFILL and (not causal or window):
                        continue          # full width: the model's causal case only
                    q = randn(gen, (b, s, h, d), dtype, dev)
                    kk = randn(gen, (b, s, k, d), dtype, dev)
                    v = randn(gen, (b, s, k, d), dtype, dev)
                    got = K.flash_attention(q, kk, v, causal=causal, window=window)
                    want = R.flash_attention_ref(*f32(q, kk, v), causal, window)
                    err = max_err(got, want, dtype)
                    n += 1
                    if s == S_PREFILL:
                        log(f"[kernels] flash_attention full width q {tuple(q.shape)} "
                            f"kv {tuple(kk.shape)} {str(dtype)[6:]} causal: max |err| {err:.3e}")
                        key = ("flash_attention", dtype)
                        full[key] = max(full.get(key, 0.0), err)
        cases = [(shape, w, f) for shape in DECODE_SWEEP for w in (None, 48) for f in (16, 100)]
        # full width: a full cache, and Engine.generate's fill (prompt + new
        # tokens), where most cache splits hold only empty slots
        cases += [((B, h, k, d, CONTEXT), w, f)
                  for (h, k, d) in ((H, KV, D), (ZH, ZKV, ZD))
                  for w, f in ((None, CONTEXT), (256, CONTEXT), (None, PROMPT + NEW_TOKENS))]
        for (b, h, k, d, c), window, fill in cases:
            q = randn(gen, (b, h, d), dtype, dev)
            kc = randn(gen, (b, c, k, d), dtype, dev)
            vc = randn(gen, (b, c, k, d), dtype, dev)
            pos = torch.where(torch.arange(c) < fill, torch.arange(c), -1).to(torch.int32).to(dev)
            npos = torch.tensor(fill - 1, dtype=torch.int32, device=dev)
            got = K.decode_attention(q, kc, vc, pos, npos, window=window)
            err = max_err(got, R.decode_attention_ref(*f32(q, kc, vc), pos, npos, window), dtype)
            n += 1
            if c == CONTEXT:
                log(f"[kernels] decode_attention full width q {tuple(q.shape)} cache "
                    f"{tuple(kc.shape)} {str(dtype)[6:]} window {window} fill {fill}: "
                    f"max |err| {err:.3e}")
                key = ("decode_attention", dtype)
                full[key] = max(full.get(key, 0.0), err)
        # ring buffer that has wrapped: slot i < 10 holds position i + c
        c = 64
        q = randn(gen, (1, 2, 16), dtype, dev)
        kc, vc = randn(gen, (1, c, 2, 16), dtype, dev), randn(gen, (1, c, 2, 16), dtype, dev)
        pos = torch.where(torch.arange(c) < 10, torch.arange(c) + c, torch.arange(c))
        pos = pos.to(torch.int32).to(dev)
        npos = torch.tensor(c + 9, dtype=torch.int32, device=dev)
        max_err(K.decode_attention(q, kc, vc, pos, npos, window=c),
                R.decode_attention_ref(*f32(q, kc, vc), pos, npos, c), dtype)
        n += 1
    torch.cuda.synchronize()
    log(f"[kernels] {n} comparisons within tolerance (f32 2e-5; bf16 atol 2e-5 rtol 4e-3 "
        f"against the plain version in f32; TF32 off)")
    errs = {name: full[(name, torch.bfloat16)] for name in ("flash_attention", "decode_attention")}
    errs.update(phase_scan_kernels(dev, gen))
    return errs


def rwkv6_inputs(gen, shape, decay_strength, dev):
    b, s, h, dk = shape
    r, k, v, w = (randn(gen, shape, torch.float32, dev) for _ in range(4))
    logw = (torch.full_like(w, -25.0) if decay_strength is None
            else -F.softplus(w * decay_strength))
    return r, k, v, logw, randn(gen, (h, dk), torch.float32, dev)


def mamba2_inputs(gen, shape, dev):
    b, s, h, p, n = shape
    x = randn(gen, (b, s, h, p), torch.float32, dev)
    dt = F.softplus(randn(gen, (b, s, h), torch.float32, dev))
    a = -torch.exp(randn(gen, (h,), torch.float32, dev) * 0.2)
    return x, dt, a, randn(gen, (b, s, n), torch.float32, dev), randn(gen, (b, s, n), torch.float32, dev)


def phase_scan_kernels(dev, gen):
    """The two scan kernels against their step recurrences, f32 at 2e-4;
    returns the largest full-width error of each."""
    from repro_torch import kernels as K
    from repro_torch.kernels import ref as R

    full = {"rwkv6_wkv": 0.0, "mamba2_ssd": 0.0}
    n = 0
    cases = [(shape, c, ds) for shape in RWKV_SWEEP for c in (16, 32, 64) for ds in (0.5, 6.0)]
    cases += [((1, 64, 1, 16), 32, None)]                 # logw = -25: stays finite
    # lengths that are no multiple of the 32-row fold tile, with the chunk
    # the model picks (the largest divisor of S up to 32), every head width
    cases += [((2, s, 3, dk), c, ds) for s, c in ((37, 1), (96, 32), (100, 25))
              for dk in (16, 32, 64) for ds in (0.5, 6.0, None)]
    cases += [(RWKV_FULL, RWKV_CHUNK, ds) for ds in (0.5, 6.0, None)]
    for shape, chunk, ds in cases:
        args = rwkv6_inputs(gen, shape, ds, dev)
        got = K.rwkv6_wkv(*args, chunk)
        if not torch.isfinite(got).all():
            raise AssertionError(f"rwkv6_wkv {shape} decay {ds}: not finite")
        err = max_err(got, R.rwkv6_wkv_ref(*args), torch.float32, SCAN_TOL)
        n += 1
        if shape == RWKV_FULL:
            log(f"[kernels] rwkv6_wkv full width {shape} chunk {chunk} decay strength {ds}: "
                f"max |err| {err:.3e}")
            full["rwkv6_wkv"] = max(full["rwkv6_wkv"], err)
    cases = [(shape, c, hb) for shape in MAMBA_SWEEP for c in (16, 32) for hb in (2, 4)]
    cases += [((1, 100, 4, 8, 16), 100, 4)]               # a ragged 64-row sub-tile
    cases += [((2, s, 4, p, n), s, 4) for s in (37, 96, 100)
              for p, n in ((16, 32), (32, 64), (64, 16))]  # ragged, odd, P and N 16-64
    cases += [(MAMBA_FULL, MAMBA_CHUNK, MAMBA_HB)]
    for shape, chunk, hb in cases:
        args = mamba2_inputs(gen, shape, dev)
        err = max_err(K.mamba2_ssd(*args, chunk, hb), R.mamba2_ssd_ref(*args), torch.float32,
                      SCAN_TOL)
        n += 1
        if shape == MAMBA_FULL:
            log(f"[kernels] mamba2_ssd full width x {shape[:4]} N {shape[4]} chunk {chunk} "
                f"head_block {hb}: max |err| {err:.3e}")
            full["mamba2_ssd"] = err
    torch.cuda.synchronize()
    log(f"[kernels] {n} scan comparisons within tolerance (f32 atol 2e-4 rtol 2e-4 against "
        f"the step recurrences)")
    log(f"[kernels] scans at full width, split TF32: rwkv6_wkv max |err| "
        f"{full['rwkv6_wkv']:.3e}, mamba2_ssd max |err| {full['mamba2_ssd']:.3e} (limit 2e-4 + "
        f"2e-4 |want|)")
    return full


def to_device(tree, device):
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def expected_counts(arch: str, steps: int) -> dict:
    """Launches of one prefill and ``steps`` decode steps on ``arch``'s path."""
    path = PATHS[arch]
    return {name: path["prefill"].get(name, 0) + steps * path["step"].get(name, 0)
            for name in KERNELS}


def phase_model(dev, arch: str):
    """The smoke model's CUDA path against its CPU path, then the arch's
    main path at full width with its launches counted, then prefill
    against token-by-token decode."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime import Engine, ServeConfig

    # small model: the CUDA path (kernels) against the CPU path (plain
    # versions), which the CPU tests hold against the JAX reference
    small = Model(get_config(arch, smoke=True))
    p_cpu = small.init(seed=1, device="cpu")
    p_gpu = to_device(p_cpu, dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 64)))
    with torch.inference_mode():
        want = small.prefill(p_cpu, {"tokens": toks})
        got = small.prefill(p_gpu, {"tokens": toks.to(dev)}).cpu()
        err = (got - want).abs().max().item()
        if not err <= 1e-3:
            raise AssertionError(f"{arch} small model: CUDA prefill vs CPU prefill max |err| "
                                 f"{err:.3e}")
        st_c = small.init_decode_state(2, 16, device="cpu")
        st_g = small.init_decode_state(2, 16, device=dev)
        for t in range(16):
            lc, st_c = small.decode_step(p_cpu, st_c, toks[:, t])
            lg, st_g = small.decode_step(p_gpu, st_g, toks[:, t].to(dev))
        err_d = (lg.cpu() - lc).abs().max().item()
        if not err_d <= 1e-3:
            raise AssertionError(f"{arch} small model: CUDA decode vs CPU decode max |err| "
                                 f"{err_d:.3e}")
    log(f"[model] smoke {arch} f32, CUDA vs CPU path: prefill max |err| {err:.3e}, "
        f"16-step decode max |err| {err_d:.3e} (tolerance 1e-3)")

    cfg = get_config(arch)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"[model] {cfg.name} full width, bf16: {model.num_params() / 1e9:.3f}B params "
        f"initialised on the card in {time.perf_counter() - t0:.3f}s")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S_PREFILL)).astype(np.int32))

    # ---- the main path, with the launch counters read around it
    K.reset_launch_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits = model.prefill(params, {"tokens": prompts.to(dev)})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
    after_prefill = K.launch_counts()
    engine = Engine(model, ServeConfig(batch=B, context=CONTEXT), device=dev)
    out, rec = engine.generate(params, prompts[:, :PROMPT].numpy(), max_new_tokens=NEW_TOKENS)
    counts = K.launch_counts()
    # ----
    if logits.shape != (B, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{arch} prefill logits {tuple(logits.shape)} not finite/shaped")
    if out.shape != (B, NEW_TOKENS) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"{arch} generated tokens {out.shape} out of range")
    steps = PROMPT + NEW_TOKENS
    for name, seen, want_counts in (("prefill", after_prefill, expected_counts(arch, 0)),
                                    ("main path", counts, expected_counts(arch, steps))):
        if seen != want_counts:
            raise AssertionError(f"{arch}: launches after the {name} {seen}, expected "
                                 f"{want_counts}")
    log(f"[model] {arch} launches on the main path: {counts} (per prefill "
        f"{PATHS[arch]['prefill']}; per decode step {PATHS[arch]['step']} over {steps} steps)")
    log(f"[model] {arch} first prefill ({B} x {S_PREFILL} tokens) {t_prefill * 1e3:.3f} ms; "
        f"generated {out.shape}, first row {out[0, :8].tolist()}")
    rep = engine.report()
    for row in rec.breakdown_table():
        log(f"[model]   {row['stage']:>16s}: mean {row['mean'] * 1e3:8.3f} ms  cv {row['cv']:.3f}")
    log(f"[model] {arch} decode step mean {rep['mean_s'] * 1e3:.3f} ms cv {rep['cv']:.3f} p99 "
        f"{rep['p99_s'] * 1e3:.3f} ms -> {B / rep['mean_s']:.1f} tokens/s (batch {B})")

    # ---- prefill vs token-by-token decode over one prompt
    agree_len = PATHS[arch]["agree"]
    agree = prompts[:, :agree_len].to(dev)
    with torch.inference_mode():
        pre = model.prefill(params, {"tokens": agree}).float()
        state = model.init_decode_state(B, agree_len, device=dev)
        for t in range(agree_len):
            dec, state = model.decode_step(params, state, agree[:, t])
    rel = ((dec - pre).abs().max() / pre.abs().max()).item()
    same = (dec.argmax(-1) == pre.argmax(-1)).float().mean().item()
    log(f"[model] {arch} prefill vs {agree_len}-step decode, last position: max |diff| / max "
        f"|logit| = {rel:.3e} (tolerance 5e-2: bf16 activations rounded in differently shaped "
        f"products over {cfg.num_layers} layers); argmax agreement {same:.2f}")
    if not rel <= 5e-2:
        raise AssertionError(f"{arch}: prefill and decode disagree")
    return model, params, counts, rep


def _device_us(evt) -> float:
    # the attribute's name changed across torch versions
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def phase_profile(model, params, dev, step_s: float, prefill_s: float):
    """Device time by kernel for one prefill and a few decode steps
    (torch.profiler); the device's busy share is its summed kernel time
    over the unprofiled wall time of the same work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (B, S_PREFILL)).astype(np.int32)).to(dev)
    n_steps = 4
    with torch.inference_mode():
        state = model.init_decode_state(B, CONTEXT, device=dev)
        for t in range(PROMPT):
            _, state = model.decode_step(params, state, toks[:, t])
        torch.cuda.synchronize()
        runs = {
            "prefill": (lambda: model.prefill(params, {"tokens": toks}), 1, prefill_s),
            "decode step": (lambda: model.decode_step(params, state, toks[:, PROMPT]),
                            n_steps, step_s),
        }
        for name, (fn, reps, wall_s) in runs.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            # device-side events only: a CPU op's device time repeats its kernels'
            rows = [(e.key, _device_us(e) / reps, e.count // reps)
                    for e in prof.key_averages()
                    if e.device_type != DeviceType.CPU and _device_us(e) > 0]
            rows.sort(key=lambda r: -r[1])
            total_ms = sum(r[1] for r in rows) / 1e3
            log(f"[profile] {model.cfg.name} {name}: device busy {total_ms:.3f} ms of {wall_s * 1e3:.3f} ms wall "
                f"({total_ms / (wall_s * 1e3):.3f} busy, {1 - total_ms / (wall_s * 1e3):.3f} idle); "
                f"{sum(r[2] for r in rows)} kernels")
            for key, us, count in rows[:8]:
                log(f"[profile]   {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def prefill_ms(model, params, dev, iters=3):
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (B, S_PREFILL)).astype(np.int32)).to(dev)
    times = []
    with torch.inference_mode():
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def sdpa(q, k, v, **kw):
    """scaled_dot_product_attention on (B,H,S,D) tensors with grouped KV
    heads; timed here only, the port never calls it."""
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_flash(K, R, gen, dev, h, kv, d):
    dt = torch.bfloat16
    q = randn(gen, (B, S_PREFILL, h, d), dt, dev)
    k = randn(gen, (B, S_PREFILL, kv, d), dt, dev)
    v = randn(gen, (B, S_PREFILL, kv, d), dt, dev)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ks, ls = rounds_ms(lambda: K.flash_attention(q, k, v, causal=True),
                       lambda: sdpa(qt, kt, vt, is_causal=True), 20)
    ms, lib = statistics.median(ks), statistics.median(ls)
    plain = graph_ms(lambda: R.flash_attention_ref(q, k, v, True, None), 3)
    lib_err = (sdpa(qt, kt, vt, is_causal=True).transpose(1, 2).float()
               - K.flash_attention(q, k, v).float()).abs().max().item()
    esz = q.element_size()
    pairs = S_PREFILL * (S_PREFILL + 1) // 2
    b_ms, b_by = bound((2 * q.numel() + k.numel() + v.numel()) * esz,
                       4.0 * B * h * d * pairs, dt)
    log(f"[times] flash_attention q {tuple(q.shape)} kv {tuple(k.shape)} bf16 causal: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms (|sdpa - kernel| {lib_err:.2e}), "
        f"bound {b_ms:.4f} ms ({b_by}); {b_ms / ms:.3f} of bound")
    log(f"[times]   {ROUNDS} rounds: kernel {spread(ks)}; sdpa {spread(ls)}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def time_decode(K, R, gen, dev, h, kv, d):
    """Cycles over caches larger than the 50 MB L2 together, as the layers
    (or sites) of a decode step each read their own cache."""
    dt = torch.bfloat16
    n_copies = 4
    qd = randn(gen, (B, h, d), dt, dev)
    caches = [(randn(gen, (B, CONTEXT, kv, d), dt, dev), randn(gen, (B, CONTEXT, kv, d), dt, dev))
              for _ in range(n_copies)]
    caches_t = [(kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous())
                for kc, vc in caches]
    pos = torch.arange(CONTEXT, dtype=torch.int32, device=dev)
    npos = torch.tensor(CONTEXT - 1, dtype=torch.int32, device=dev)
    mask = (pos <= npos).view(1, 1, 1, CONTEXT)
    qdt = qd.view(B, h, 1, d)
    it = {"i": 0}

    def cyc(fn):
        def call():
            it["i"] = (it["i"] + 1) % n_copies
            return fn(it["i"])
        return call

    ks, ls = rounds_ms(cyc(lambda i: K.decode_attention(qd, *caches[i], pos, npos)),
                       cyc(lambda i: sdpa(qdt, *caches_t[i], attn_mask=mask)), 200)
    ms, lib = statistics.median(ks), statistics.median(ls)
    plain = graph_ms(cyc(lambda i: R.decode_attention_ref(qd, *caches[i], pos, npos)), 40)
    lib_err = (sdpa(qdt, *caches_t[0], attn_mask=mask).view(B, h, d).float()
               - K.decode_attention(qd, *caches[0], pos, npos).float()).abs().max().item()
    nbytes = (2 * qd.numel() + 2 * caches[0][0].numel()) * qd.element_size() + 4 * (CONTEXT + 1)
    b_ms, b_by = bound(nbytes, 4.0 * B * h * d * CONTEXT, dt)
    from repro_torch.kernels.decode_attention import TILE, splits_for
    splits, tiles = splits_for(dev.index, B, h, kv, CONTEXT, d, dt), -(-CONTEXT // TILE)
    log(f"[times] decode_attention at these shapes: {splits} splits of "
        f"{-(-tiles // splits)} tiles per (batch, KV head)")
    log(f"[times] decode_attention q {tuple(qd.shape)} cache {tuple(caches[0][0].shape)} bf16 "
        f"(all {CONTEXT} slots valid): kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa "
        f"{lib:.4f} ms (|sdpa - kernel| {lib_err:.2e}), bound {b_ms:.4f} ms ({b_by}); "
        f"{b_ms / ms:.3f} of bound")
    log(f"[times]   {ROUNDS} rounds: kernel {spread(ks)}; sdpa {spread(ls)}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def kernel_rounds(fn, iters: int) -> list[float]:
    """``ROUNDS`` timings of ``fn`` (one CUDA graph, replayed each round)."""
    graph = capture(fn, iters)
    return [replay_ms(graph, iters) for _ in range(ROUNDS)]


def time_scans(K, R, gen, dev):
    """The scans at their full-width shapes, medians of ROUNDS rounds.
    Bounds: each input read once and the output written once (f32), against
    the least arithmetic of the recurrence, one rank-1 update of the state
    and one read of it per position and head, a multiply-add per state
    element each: 4 K^2 (RWKV6) and 4 P N (Mamba2) flops, at the rate of
    the units the design uses: split TF32, three tensor-core passes at
    495 TFLOP/s (the f32 CUDA-core rate, 67 TFLOP/s, is logged beside it).
    The decays fold into these in the chunked form.  No single PyTorch call
    computes either scan."""
    res = {}
    for name, shape in (("rwkv6_wkv", RWKV_FULL), ("mamba2_ssd", MAMBA_FULL)):
        if name == "rwkv6_wkv":
            b, s, h, dk = shape
            args = rwkv6_inputs(gen, shape, 0.5, dev)
            call = lambda: K.rwkv6_wkv(*args, RWKV_CHUNK)  # noqa: E731
            plain = lambda: R.rwkv6_wkv_ref(*args)  # noqa: E731
            nbytes = (5 * args[0].numel() + args[4].numel()) * 4
            flops = 4.0 * b * s * h * dk * dk
            what = f"{shape} f32 chunk {RWKV_CHUNK}"
        else:
            b, s, h, p, n = shape
            args = mamba2_inputs(gen, shape, dev)
            call = lambda: K.mamba2_ssd(*args, MAMBA_CHUNK, MAMBA_HB)  # noqa: E731
            plain = lambda: R.mamba2_ssd_ref(*args)  # noqa: E731
            nbytes = (2 * args[0].numel() + sum(x.numel() for x in args[1:])) * 4
            flops = 4.0 * b * s * h * p * n
            what = f"x {shape[:4]} N {n} f32 chunk {MAMBA_CHUNK} head_block {MAMBA_HB}"
        ks = kernel_rounds(call, 20)
        ms = statistics.median(ks)
        plain_ms = graph_ms(plain, 1, replays=2)
        b_ms, b_by = bound(nbytes, TF32_PASSES * flops, "tf32")
        f32_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
        res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)
        log(f"[times] {name} {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {flops / 1e9:.2f} GFLOP x {TF32_PASSES} "
            f"split-TF32 passes at 495 TFLOP/s = {TF32_PASSES * flops / PEAK_FLOPS['tf32'] * 1e3:.4f}"
            f" ms; at the f32 CUDA-core rate it would read {f32_ms:.4f} ms); "
            f"{b_ms / ms:.3f} of bound")
        log(f"[times]   {ROUNDS} rounds: kernel {spread(ks)}")
    return res


def phase_times(dev):
    """Each kernel at its main path's full-width shapes; the attention
    kernels' rows are at qwen3-4b's head_dim 128, with zamba2's head_dim 80
    timed beside them."""
    from repro_torch import kernels as K
    from repro_torch.kernels import ref as R

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    res = {"flash_attention": time_flash(K, R, gen, dev, H, KV, D),
           "decode_attention": time_decode(K, R, gen, dev, H, KV, D)}
    time_flash(K, R, gen, dev, ZH, ZKV, ZD)
    time_decode(K, R, gen, dev, ZH, ZKV, ZD)
    res.update(time_scans(K, R, gen, dev))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout of the repo",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")

    t_all = time.perf_counter()
    phase_build()
    errs = phase_kernels(dev)
    launches = dict.fromkeys(KERNELS, 0)
    for arch in PATHS:
        model, params, counts, rep = phase_model(dev, arch)
        for name in KERNELS:
            launches[name] += counts[name]
        pre = prefill_ms(model, params, dev)
        log(f"[times] {arch} Model.prefill {B} x {S_PREFILL} tokens: "
            f"{', '.join(f'{t:.3f}' for t in pre)} ms")
        phase_profile(model, params, dev, rep["mean_s"], min(pre) / 1e3)
        del model, params
        torch.cuda.empty_cache()
    times = phase_times(dev)

    rows = []
    for name, (source, replaces) in SOURCES.items():
        t = times[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{source}",
                     "replaces": f"src/repro/kernels/{replaces}",
                     "launches": launches[name], "max_abs_err": errs[name],
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "design": DESIGNS[name]})
    if any(not math.isfinite(r["ms"]) for r in rows):
        raise AssertionError("non-finite kernel time")
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f}s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
