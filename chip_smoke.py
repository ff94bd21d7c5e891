#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Eight serving paths at full width, five hand-written kernels (the four
forwards and the flash attention backward), the perception frame path,
batched multi-camera perception and scenario replay (which run none of
them), multi-tenant decode serving (decode_attention in every shared
step) and training (qwen3-4b at full width and depth: the flash forward
and backward kernels): qwen3-4b
(dense: flash_attention, decode_attention), rwkv6-3b (ssm: rwkv6_wkv),
zamba2-2.7b (hybrid: mamba2_ssd, and flash/decode attention at head_dim 80
in the shared block), olmoe-1b-7b (moe, 64 experts top-8: the moe, vlm and
audio slice's main path), internvl2-1b (vlm: 256 patch embeddings then
text; head_dim 64, GQA group 7), hubert-xlarge (audio encoder: non-causal
flash at head_dim 80, no decode), mixtral-8x22b (moe, 8 experts top-2,
depth cut to 2 of 56 layers; a 4096 window over an 8192 prefill) and
granite-20b (MQA, group 48); qwen2-7b and yi-6b at smoke size only.  bf16 flash runs the wgmma/TMA kernel, f32 flash the
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
             (head_dim 80) shapes, and the new paths' full-width shapes
             (FLASH_FULL, DECODE_FULL: olmoe, internvl2's group of 7,
             hubert's non-causal head_dim 80, mixtral's 4096 window over
             8192, granite's MQA), at float32 and bfloat16, each held
             against its plain version run in float32 on the same inputs
             (tolerances at TOL).  Scans: the reference's sweeps
             (tests/test_kernels.py:96-180, logw = -25 included), ragged
             and odd lengths (S = 37, 96, 100) at head widths and state
             sizes of 16, 32 and 64, and the full-width shapes, rwkv6 at
             (4,1024,40,64) chunk 64 with decay strength 0.5 and 6.0 and
             logw = -25, mamba2 at x (4,1024,80,64), N 64, chunk 256,
             head_block 8; f32 at the reference's 2e-4, the full-width
             errors printed.  TF32 off (the scans' own split TF32 is
             written in their kernels).  The flash backward kernel
             (dq, dk, dv), given the forward's output and rows'
             log-sum-exp, against the f32 formulas of its plain version
             at TOL, f32 and bf16: FLASH_BWD_SWEEP and the full-width
             shapes of FLASH_BWD_FULL (qwen3-4b's training shape 2 x 1024,
             hubert's non-causal head_dim 80, mixtral's 4096 window over
             8192, internvl2's group of 7); at each, the forward's lse
             against ref.flash_attention_lse_ref and its output with and
             without the lse buffer, bit for bit;
3. model   — for each arch of PATHS: the port's CUDA path against its CPU
             path on the smoke model (f32, 1e-3: cuBLAS and CPU sum in
             different orders); then the arch's main path at full width in
             bf16 with seeded random weights: Model.prefill on 4 x 1024
             tokens and Engine.generate answering 4 requests (context 1024,
             prompt 64, 32 new tokens), with the kernels' launch counters
             reset just before and read just after, and each counter held
             to the launches that path must make (PATHS).  The new paths:
             internvl2-1b prefills 256 patch embeddings (width 1024) and
             768 tokens and generates text only; hubert-xlarge runs
             ``forward`` on 4 x 1024 frames (width 512), no decode;
             mixtral-8x22b (2 layers) prefills 1 x 8192 and granite-20b
             1 x 1024, each then Engine.generate at batch 1, prompt 4, 4
             new tokens.  For the MoE archs the full-width prefill's
             drop_fraction (a forward of the same batch).  Then prefill
             against token-by-token decode on one prompt (128 tokens; 256
             for zamba2, whose prefill needs whole 256-row SSD chunks; MoE
             on a drop-free copy of the config, capacity_factor =
             num_experts, since a prefill group drops its latest tokens by
             design and a decode group never does; not the VLM, whose
             decode is text-only, nor the encoder).  qwen2-7b and yi-6b:
             the smoke CUDA-against-CPU check only;
4. times   — per arch: Model.prefill wall time (forward for the encoder)
             and, for the first four paths, the device time by kernel for a
             prefill and for decode steps (torch.profiler) with the
             device's busy share; each kernel, its plain version
             and, for attention, the PyTorch library call
             (scaled_dot_product_attention, with |sdpa - kernel|; for the
             backward kernel SDPA's backward, timed between CUDA events,
             and each of its three launches from the profiler)
             at the full-width shapes, device time only (calls captured in a CUDA
             graph, replayed between CUDA events; for attention the median
             of ROUNDS rounds, kernel and SDPA alternating, with the range
             printed; the scans as medians of ROUNDS rounds too); the bound
             from the shapes and the H100's peaks.  No single PyTorch call
             computes either scan, so their library_ms is null;
5. perception — the perception frame path (repro_torch.perception and
             repro_torch.anytime), which runs none of the kernels:
             every registered pipeline at lambda = 1 and the five rungs of
             the anytime ladder (unpadded), built on the card and on the
             CPU from the same seed-7 weights, over PERCEPTION_FRAMES frames
             of each of PERCEPTION_SCENES; per frame the counts must be
             equal and the boxes within BOX_TOL_PX.  cuDNN's TF32 is put back
             to torch's default for this phase, so the backbone's own f32
             setting is what the check exercises.  Then, on the card: stage
             times (mean, CV, p99) per pipeline and scene, the Pearson r of
             post-processing time against the proposal count (two_stage,
             lane), launches per frame and the device's busy share of the
             inference stage (torch.profiler), and the anytime A/B of
             benchmarks/anytime.py (city seed 3, calibrate n=12, 40 frames
             per arm, budgets 0.5, 1.0 and 2.5 x the top rung's mean) with
             the calibrated ladder held against the CPU's.  The kernels'
             launch counters must stay at zero over the phase;
6. batched — batched multi-camera perception (repro_torch.batched), which
             runs none of the kernels either: at capacity
             BATCH_CAPACITY, the five ladder rungs (unpadded) and both lane
             pipelines through the engine on the card (one CUDA graph per
             engine) against the serial run_frame on the card and against
             the engine on the CPU (counts equal, boxes within BOX_TOL_PX);
             depths 2 and 3 against depth 1 bit for bit (every output
             leaf); a join/leave churn with one capture and one replay a
             tick, run under torch.cuda.set_sync_debug_mode("error");
             per rung at 1, 2, 4 and 8 streams and depths 1 and 2 the host
             API calls a tick (graph launches, copies, others), the device's
             kernels, copies and busy share of a tick (torch.profiler); the
             frames/s of the engine against the serial run_frame loop as
             benchmarks/batched.py measures it (two_stage, one_stage,
             early_exit; 24 ticks); and the RungBucketScheduler with 4
             streams at 0.5 x and 4 at 2.5 x the top rung's warmed batched
             step for SCHED_TICKS ticks at depths 1 and 2 (bucket sizes,
             miss rate and quality per group, the floor and top rungs' step
             at capacity 8).  The kernels' launch counters must stay at
             zero over the phase;
7. scenarios — scenario replay (repro_torch.scenarios), which runs none of
             the kernels: the two golden episodes (urban_rush_hour,
             rain_onset_clear) replayed through one scheduler at
             GOLDEN_CAPACITY on the card and through another on the CPU,
             with the port's seed-7 weights; the reports must agree on
             every count, rung histogram, fusion count and modeled latency,
             mean_quality within QUALITY_TOL; each card episode's tick loop
             runs under torch.cuda.set_sync_debug_mode("error") and is
             timed; each rung engine is captured once across both
             episodes.  Then the obs contract of repro_torch.obs on the
             card (trace schema, no dropped span, the report byte-identical
             with tracing on and off, the hardware axis's share of the
             contention variance), and a one-shard fleet run as
             launch/serve.py --fleet makes it (FLEET_STREAMS streams,
             FLEET_TICKS ticks: frames per virtual second, wall seconds).
             Printed as information: the card reports' violations of
             tests/golden (those fixtures come from the reference's
             weights);
8. multi_tenant — the multi-tenant runtime (repro_torch.runtime): the smoke
             qwen3-4b and rwkv6-3b engines in f32 on the card against the
             CPU (one queued workload, AlwaysAdmit: the same tokens, slots
             and ramp steps per tenant); qwen3-4b at full width in bf16,
             capacity MT_CAPACITY, context MT_CONTEXT, MT_STREAMS Poisson
             streams at MT_RATE Hz through the broker (prompt MT_PROMPT,
             MT_NEW new tokens), AdmissionController and the mean deadline
             policy, with the launch counters reset just before the drain
             and read just after: decode_attention must launch steps x 36
             times and nothing else, the step is built once, and every
             tenant ends finished or shed; the per-tenant table, step
             mean, CV and p99, tokens/s and the device's busy share of one
             step (torch.profiler); then rwkv6-3b at full width, capacity
             1: a tenant that follows another in the slot generates what
             it generates in a fresh engine;
9. train   — the training path (repro_torch.train, as launch/train.py
             drives it): qwen3-4b at full width and depth in bf16, remat
             on, TRAIN_STEPS AdamW steps of TRAIN_B x TRAIN_S tokens through
             Trainer.fit, with the launch counters reset just before fit
             and read just after: flash_attention 2 x 36 and
             flash_attention_bwd 36 a step, nothing else; the first step's
             loss against a no-grad Model.loss of the same batch, every
             loss finite and the last below the first; step mean, CV, p99,
             tokens/s, the device's busy share of one step
             (torch.profiler), peak memory; then on smoke models a
             checkpoint round trip on the card and rwkv6-3b and
             zamba2-2.7b raising NotImplementedError under grad (their
             scans have no backward kernel yet) without a launch.

The build phase prints each kernel's registers, static shared memory and
spill bytes from the compiler's -Xptxas -v report, and the scan kernels'
blocks per SM from the occupancy API.  Prints the card's name
and power limit, one ``{"kernels": [...]}`` line (each row also names the
kernel's design and splits ``launches`` by path: each arch's prefill and
Engine.generate, and the multi-tenant drain), and as the last
line ``{"ok": true, "device": {...}}``.  (Phase 4, times, runs last.)
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
# Keys beside those: the path's shapes where they differ from SHAPE, the
# VLM's patch count (of the prefill's length), a depth cut (layers), and
# whether phase_profile traces it.  agree=0 skips the check: the VLM's
# decode is text-only (its prefill starts with the patches) and the audio
# encoder has no decode.
SHAPE = dict(batch=B, seq=S_PREFILL, context=CONTEXT, prompt=PROMPT, new=NEW_TOKENS)
PATHS = {
    "qwen3-4b": dict(prefill={"flash_attention": 36}, step={"decode_attention": 36}, agree=128),
    "rwkv6-3b": dict(prefill={"rwkv6_wkv": 32}, step={}, agree=128),
    "zamba2-2.7b": dict(prefill={"mamba2_ssd": 54, "flash_attention": 9},
                        step={"decode_attention": 9}, agree=256),
    # the moe, vlm and audio families (the slice's main path is olmoe-1b-7b)
    "olmoe-1b-7b": dict(prefill={"flash_attention": 16}, step={"decode_attention": 16},
                        agree=128),
    "internvl2-1b": dict(prefill={"flash_attention": 24}, step={"decode_attention": 24},
                         agree=0, patches=256, profile=False),
    "hubert-xlarge": dict(prefill={"flash_attention": 48}, step={}, agree=0, profile=False),
    "mixtral-8x22b": dict(prefill={"flash_attention": 2}, step={"decode_attention": 2},
                          agree=128, layers=2, batch=1, seq=8192, prompt=4, new=4,
                          profile=False),
    "granite-20b": dict(prefill={"flash_attention": 52}, step={"decode_attention": 52},
                        agree=128, batch=1, prompt=4, new=4, profile=False),
}
# archs whose blocks are another path's (qwen3-4b's with qkv_bias): their
# smoke models only, CUDA path against CPU path
SMOKE_ONLY = ("qwen2-7b", "yi-6b")
# the attention kernels at the new paths' full-width shapes:
# flash (b, s, h, kv, d, causal, window) and decode (b, h, kv, d, cache, window)
FLASH_FULL = [(B, S_PREFILL, 16, 16, 128, True, None),      # olmoe-1b-7b
              (B, S_PREFILL, 14, 2, 64, True, None),        # internvl2-1b, G = 7
              (B, S_PREFILL, 16, 16, 80, False, None),      # hubert-xlarge, non-causal
              (1, 8192, 48, 8, 128, True, 4096),            # mixtral-8x22b, window 4096
              (1, S_PREFILL, 48, 1, 128, True, None)]       # granite-20b, MQA
DECODE_FULL = [(B, 16, 16, 128, CONTEXT, None),             # olmoe-1b-7b
               (B, 14, 2, 64, CONTEXT, None),               # internvl2-1b, G = 7 (GB 1)
               (1, 48, 8, 128, CONTEXT, 4096),              # mixtral-8x22b
               (1, 48, 1, 128, CONTEXT, None)]              # granite-20b, G = 48

# the training path (phase 9): qwen3-4b at full width and depth, batch 2 x
# 1024, TRAIN_STEPS AdamW steps (the CLI's warmup, min(20, steps // 5 + 1))
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = "qwen3-4b", 2, 1024, 6, 1e-3
# the flash backward kernel: small shapes (ragged S, every head_dim class,
# windows with and without causality) and the full-width shapes: the
# training path's, and the other attention families' (b, s, h, kv, d,
# causal, window)
FLASH_BWD_SWEEP = [(1, 128, 4, 4, 32, True, None), (2, 200, 8, 2, 64, True, 96),
                   (1, 100, 4, 1, 16, False, None), (2, 256, 4, 2, 80, False, 96)]
FLASH_BWD_FULL = [(TRAIN_B, TRAIN_S, H, KV, D, True, None),   # qwen3-4b training
                  (B, S_PREFILL, 16, 16, 80, False, None),    # hubert-xlarge, non-causal
                  (1, 8192, 48, 8, 128, True, 4096),          # mixtral-8x22b, window 4096
                  (B, S_PREFILL, 14, 2, 64, True, None)]      # internvl2-1b, G = 7

KERNELS = ("flash_attention", "flash_attention_bwd", "decode_attention", "rwkv6_wkv",
           "mamba2_ssd")
# each kernel's source, and what it replaces: a TPU kernel, or for the
# backward the gradient JAX takes of its jnp attention (the TPU package
# has no Pallas backward)
SOURCES = {"flash_attention": ("flash_attention.cu", "kernels/flash_attention.py:85"),
           "flash_attention_bwd": ("flash_attention_bwd.cu", "models/attention.py:100"),
           "decode_attention": ("decode_attention.cu", "kernels/decode_attention.py:75"),
           "rwkv6_wkv": ("rwkv6_scan.cu", "kernels/rwkv6_scan.py:109"),
           "mamba2_ssd": ("mamba2_ssd.cu", "kernels/mamba2_ssd.py:66")}
# Each kernel's design
DESIGNS = {"flash_attention": {"bfloat16": "wgmma+tma", "float32": "fma"},
           "flash_attention_bwd": {"bfloat16": "delta pass + wgmma/tma dK/dV (64 keys a "
                                               "block, items dealt to 2 consumers) + wgmma/tma "
                                               "dQ, lse from the forward, P and dS bf16 hi+lo, "
                                               "no atomics",
                                   "float32": "delta pass + fma dK/dV + fma dQ, lse from the "
                                              "forward"},
           "decode_attention": "cp.async ring + cluster merge",
           "rwkv6_wkv": "scores pre-pass + mma.sync split tf32, 16-row sub-blocks, "
                        "cp.async double buffer",
           "mamba2_ssd": "C.B^T pre-pass + mma.sync split tf32, cp.async double buffer"}
# Kernel times are medians of ROUNDS timings; for attention each kernel
# round is followed by one of SDPA, so the two see the same state of the card.
ROUNDS = 5
# the backward's launches at the training shape, profiled in phase_kernels
# (the process's first profiler session: after many sessions the profiler
# records few or none of a call's launches) and reported with its times
BWD_LAUNCH_MS: dict = {}


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
        # the multi-tenant drain's shape (phase 8): MT_CAPACITY slots, the
        # shared positions filled as far as a drain takes them
        cases += [((MT_CAPACITY, H, KV, D, MT_CONTEXT), None, f)
                  for f in (MT_PROMPT + MT_NEW, 4 * (MT_PROMPT + MT_NEW), MT_CONTEXT)]
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
        # the moe, vlm and audio paths' full-width shapes, with their masks
        for (b, s, h, k, d, causal, window) in FLASH_FULL:
            q = randn(gen, (b, s, h, d), dtype, dev)
            kk = randn(gen, (b, s, k, d), dtype, dev)
            v = randn(gen, (b, s, k, d), dtype, dev)
            got = K.flash_attention(q, kk, v, causal=causal, window=window)
            err = max_err(got, R.flash_attention_ref(*f32(q, kk, v), causal, window), dtype)
            n += 1
            log(f"[kernels] flash_attention full width q {tuple(q.shape)} kv {tuple(kk.shape)} "
                f"{str(dtype)[6:]} causal {causal} window {window}: max |err| {err:.3e}")
            full[("flash_attention", dtype)] = max(full[("flash_attention", dtype)], err)
            del q, kk, v, got
        for (b, h, k, d, c, window) in DECODE_FULL:
            for fill in (c, PROMPT + NEW_TOKENS):
                q = randn(gen, (b, h, d), dtype, dev)
                kc = randn(gen, (b, c, k, d), dtype, dev)
                vc = randn(gen, (b, c, k, d), dtype, dev)
                pos = torch.where(torch.arange(c) < fill, torch.arange(c), -1)
                pos = pos.to(torch.int32).to(dev)
                npos = torch.tensor(fill - 1, dtype=torch.int32, device=dev)
                err = max_err(K.decode_attention(q, kc, vc, pos, npos, window=window),
                              R.decode_attention_ref(*f32(q, kc, vc), pos, npos, window), dtype)
                n += 1
                log(f"[kernels] decode_attention full width q {tuple(q.shape)} cache "
                    f"{tuple(kc.shape)} {str(dtype)[6:]} window {window} fill {fill}: "
                    f"max |err| {err:.3e}")
                full[("decode_attention", dtype)] = max(full[("decode_attention", dtype)], err)
        torch.cuda.empty_cache()
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
    errs["flash_attention_bwd"] = phase_bwd_kernel(dev, gen)
    errs.update(phase_scan_kernels(dev, gen))
    return errs


def phase_bwd_kernel(dev, gen) -> float:
    """The flash backward kernel against its plain version (the f32
    formulas of ref.flash_attention_bwd_ref) on the same inputs: o and the
    rows' log-sum-exp are the forward kernel's, dO standard normal; at TOL,
    as the forward (both compute in f32 from the same inputs; bf16 rounds
    dq, dk and dv once).  At each shape the forward's lse is held against
    ref.flash_attention_lse_ref at TOL[float32] (it is f32 in both dtypes)
    and its output with the lse buffer against its output without it, bit
    for bit.  Returns the largest full-width bf16 error."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, \
        flash_attention_cuda

    worst, lse_worst, n = 0.0, 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLASH_BWD_SWEEP + FLASH_BWD_FULL:
            b, s, h, k, d, causal, window = shape
            q, kk, v, do = (randn(gen, shp, dtype, dev)
                            for shp in ((b, s, h, d), (b, s, k, d), (b, s, k, d), (b, s, h, d)))
            lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
            o = flash_attention_cuda(q, kk, v, causal=causal, window=window, lse=lse)
            if not torch.equal(o, flash_attention_cuda(q, kk, v, causal=causal, window=window)):
                raise AssertionError(f"flash_attention at {shape} {str(dtype)[6:]}: the output "
                                     f"with the lse buffer differs from the output without it")
            try:
                lse_err = max_err(lse, R.flash_attention_lse_ref(*f32(q, kk), causal, window),
                                  torch.float32)
            except AssertionError as e:
                raise AssertionError(f"flash_attention lse at {shape} {str(dtype)[6:]}: {e}") \
                    from None
            lse_worst = max(lse_worst, lse_err)
            got = flash_attention_bwd_cuda(q, kk, v, o, do, lse, causal, window)
            want = R.flash_attention_bwd_ref(*f32(q, kk, v, o, do), causal, window)
            if shape == FLASH_BWD_FULL[0] and dtype == torch.bfloat16:
                BWD_LAUNCH_MS.update(bwd_launch_ms(
                    lambda: flash_attention_bwd_cuda(q, kk, v, o, do, lse, causal, window)))
            errs = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                try:
                    errs.append(max_err(g, w, dtype))
                except AssertionError as e:
                    raise AssertionError(f"flash_attention_bwd {name} at {shape} "
                                         f"{str(dtype)[6:]}: {e}") from None
            n += 1
            if shape in FLASH_BWD_FULL:
                log(f"[kernels] flash_attention_bwd full width q {tuple(q.shape)} kv "
                    f"{tuple(kk.shape)} {str(dtype)[6:]} causal {causal} window {window}: max "
                    f"|err| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}; forward lse "
                    f"{lse_err:.3e}")
                if dtype == torch.bfloat16:
                    worst = max(worst, *errs)
            del q, kk, v, do, o, lse, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[kernels] flash_attention_bwd: {n} comparisons of dq, dk and dv within tolerance "
        f"(against the f32 formulas on the same inputs, the forward's lse passed in); the "
        f"forward's lse within 2e-5 of its plain version at all {n} (max |err| "
        f"{lse_worst:.3e}), its output bit for bit the same with and without the lse buffer")
    return worst


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


def path_shape(arch: str) -> dict:
    """batch, seq (prefill length), context, prompt and new tokens of a path."""
    return {k: PATHS[arch].get(k, v) for k, v in SHAPE.items()}


def make_batch(cfg, b: int, s: int, rng, patches: int = 0) -> dict:
    """Seeded inputs of the arch's family on the CPU: tokens; for vlm
    ``patches`` patch embeddings and s - patches tokens; for audio frames."""
    if cfg.family == "audio":
        return {"frames": torch.from_numpy(
            rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32))}
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s - patches)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((b, patches, cfg.frontend_dim)).astype(np.float32))
    return batch


def run_prefill(model, params, batch: dict) -> torch.Tensor:
    """The path's prefill: ``Model.prefill``, or the encoder's ``forward``."""
    if model.cfg.encoder_only:
        return model.forward(params, batch)[0]
    return model.prefill(params, batch)


def phase_smoke(dev, arch: str):
    """The smoke model's CUDA path (kernels) against its CPU path (plain
    versions), which the CPU tests hold against the JAX reference: prefill
    (forward for the encoder) and 16 decode steps, f32, 1e-3 (cuBLAS and the
    CPU sum in different orders)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    small = Model(get_config(arch, smoke=True))
    cfg = small.cfg
    p_cpu = small.init(seed=1, device="cpu")
    p_gpu = to_device(p_cpu, dev)
    batch = make_batch(cfg, 2, 64, np.random.default_rng(1), cfg.frontend_tokens)
    toks = batch.get("tokens")
    with torch.inference_mode():
        want = run_prefill(small, p_cpu, batch)
        got = run_prefill(small, p_gpu, to_device(batch, dev)).cpu()
        err = (got - want).abs().max().item()
        if not err <= 1e-3:
            raise AssertionError(f"{arch} small model: CUDA prefill vs CPU prefill max |err| "
                                 f"{err:.3e}")
        msg = f"prefill max |err| {err:.3e}"
        if cfg.supports_decode:
            st_c = small.init_decode_state(2, 16, device="cpu")
            st_g = small.init_decode_state(2, 16, device=dev)
            for t in range(16):
                lc, st_c = small.decode_step(p_cpu, st_c, toks[:, t])
                lg, st_g = small.decode_step(p_gpu, st_g, toks[:, t].to(dev))
            err_d = (lg.cpu() - lc).abs().max().item()
            if not err_d <= 1e-3:
                raise AssertionError(f"{arch} small model: CUDA decode vs CPU decode max |err| "
                                     f"{err_d:.3e}")
            msg += f", 16-step decode max |err| {err_d:.3e}"
    log(f"[model] smoke {arch} f32, CUDA vs CPU path: {msg} (tolerance 1e-3)")


def phase_model(dev, arch: str):
    """The smoke model's CUDA path against its CPU path, then the arch's
    main path at full width with its launches counted, then prefill
    against token-by-token decode.  Returns (model, params, counts, the
    engine's report or None, the prefill batch on the card)."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.moe import moe_block
    from repro_torch.models.transformer import _unstack
    from repro_torch.runtime import Engine, ServeConfig

    phase_smoke(dev, arch)
    path, shp = PATHS[arch], path_shape(arch)
    b = shp["batch"]
    cfg = get_config(arch)
    if "layers" in path:
        cfg = cfg.replace(num_layers=path["layers"])
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    cut = f", depth cut to {cfg.num_layers} layers" if "layers" in path else ""
    log(f"[model] {cfg.name} full width{cut}, bf16: {model.num_params() / 1e9:.3f}B params "
        f"initialised on the card in {time.perf_counter() - t0:.3f}s "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB allocated)")
    rng = np.random.default_rng(0)
    batch = to_device(make_batch(cfg, b, shp["seq"], rng, path.get("patches", 0)), dev)
    what = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())

    # ---- the main path, with the launch counters read around it
    K.reset_launch_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits = run_prefill(model, params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
    after_prefill = K.launch_counts()
    out = rec = engine = None
    steps = 0
    if cfg.supports_decode:
        engine = Engine(model, ServeConfig(batch=b, context=shp["context"]), device=dev)
        prompt = batch["tokens"][:, :shp["prompt"]].cpu().numpy()
        out, rec = engine.generate(params, prompt, max_new_tokens=shp["new"])
        steps = shp["prompt"] + shp["new"]
    counts = K.launch_counts()
    # ----
    want_shape = (b, shp["seq"], cfg.vocab_size) if cfg.encoder_only else (b, cfg.vocab_size)
    if logits.shape != want_shape or not torch.isfinite(logits).all():
        raise AssertionError(f"{arch} prefill logits {tuple(logits.shape)} not finite/shaped")
    if out is not None and (out.shape != (b, shp["new"]) or out.min() < 0
                            or out.max() >= cfg.vocab_size):
        raise AssertionError(f"{arch} generated tokens {out.shape} out of range")
    for name, seen, want_counts in (("prefill", after_prefill, expected_counts(arch, 0)),
                                    ("main path", counts, expected_counts(arch, steps))):
        if seen != want_counts:
            raise AssertionError(f"{arch}: launches after the {name} {seen}, expected "
                                 f"{want_counts}")
    log(f"[model] {arch} launches on the main path: {counts} (per prefill "
        f"{path['prefill']}; per decode step {path['step']} over {steps} steps)")
    log(f"[model] {arch} first {'forward' if cfg.encoder_only else 'prefill'} ({what}) "
        f"{t_prefill * 1e3:.3f} ms" + (f"; generated {out.shape}, first row "
                                       f"{out[0, :8].tolist()}" if out is not None else
                                       "; encoder-only: no decode"))
    rep = None
    if engine is not None:
        rep = engine.report()
        for row in rec.breakdown_table():
            log(f"[model]   {row['stage']:>16s}: mean {row['mean'] * 1e3:8.3f} ms  "
                f"cv {row['cv']:.3f}")
        log(f"[model] {arch} decode step mean {rep['mean_s'] * 1e3:.3f} ms cv {rep['cv']:.3f} "
            f"p99 {rep['p99_s'] * 1e3:.3f} ms -> {b / rep['mean_s']:.1f} tokens/s (batch {b}, "
            f"context {shp['context']}, {rep['jobs']} scored steps)")
    if cfg.family == "moe":
        # the expert load this prefill met: a forward of the same batch
        with torch.inference_mode():
            _, aux = model.forward(params, batch)
        log(f"[model] {arch} full-width prefill ({what}, groups of "
            f"{cfg.moe_group_size}, capacity factor {cfg.capacity_factor}): drop_fraction "
            f"{aux['drop_fraction'].item():.6f}, load_balance_loss "
            f"{aux['load_balance_loss'].item():.6f}, router_z_loss "
            f"{aux['router_z_loss'].item():.6f} (means over {cfg.num_layers} layers)")
        # layer 0's router on i.i.d. normal inputs of the same shape: what it
        # drops when no two tokens of a group are alike
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        x_iid = torch.randn((b, shp["seq"], cfg.d_model), generator=gen, device=dev)
        with torch.inference_mode():
            layer0 = _unstack(params["layers"]["moe"])[0]
            _, aux0 = moe_block(layer0, x_iid.to(torch.bfloat16), cfg)
        log(f"[model] {arch} layer 0 on i.i.d. normal inputs {tuple(x_iid.shape)}: drop_fraction "
            f"{aux0['drop_fraction'].item():.6f}")
        del x_iid

    # ---- prefill vs token-by-token decode over one prompt; MoE on a
    # drop-free copy (capacity_factor = num_experts): a prefill group drops
    # its latest tokens by design, a decode group never does
    agree_len = path["agree"]
    if agree_len:
        agree_model = model
        if cfg.family == "moe":
            agree_model = Model(cfg.replace(capacity_factor=float(cfg.num_experts)))
        agree = batch["tokens"][:, :agree_len]
        with torch.inference_mode():
            pre = agree_model.prefill(params, {"tokens": agree}).float()
            state = agree_model.init_decode_state(b, agree_len, device=dev)
            for t in range(agree_len):
                dec, state = agree_model.decode_step(params, state, agree[:, t])
        rel = ((dec - pre).abs().max() / pre.abs().max()).item()
        same = (dec.argmax(-1) == pre.argmax(-1)).float().mean().item()
        drop_free = " (drop-free capacity)" if agree_model is not model else ""
        log(f"[model] {arch} prefill vs {agree_len}-step decode{drop_free}, last position: max "
            f"|diff| / max |logit| = {rel:.3e} (tolerance 5e-2: bf16 activations rounded in "
            f"differently shaped products over {cfg.num_layers} layers); argmax agreement "
            f"{same:.2f}")
        if not rel <= 5e-2:
            raise AssertionError(f"{arch}: prefill and decode disagree")
        del state
    return model, params, counts, rep, batch


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


def prefill_ms(model, params, batch, iters=3):
    """Wall ms of ``iters`` prefills (forwards for the encoder) of ``batch``."""
    times = []
    with torch.inference_mode():
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_prefill(model, params, batch)
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


def time_decode(K, R, gen, dev, h, kv, d, B=B):
    """Cycles over caches larger than the 50 MB L2 together, as the layers
    (or sites) of a decode step each read their own cache.  ``B`` is the
    batch: Engine.generate's, or the multi-tenant engine's capacity."""
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


def event_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn`` between CUDA events
    (after two warm-up calls), for work that is not captured in a graph."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bwd_launch_ms(fn, reps: int = 5) -> dict:
    """Mean device ms of each kernel that ``fn`` launches, from
    torch.profiler's CUDA activity over ``reps`` calls: each kernel's
    summed time over the launches the profiler recorded (printed beside
    it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU and _device_us(e) > 0:
            name = next((n for n in ("delta_kernel", "dkdv_wgmma_kernel", "dq_wgmma_kernel",
                                     "dkdv_kernel", "dq_kernel") if n in e.key), e.key[:60])
            t, c = out.get(name, (0.0, 0))
            out[name] = (t + _device_us(e) / 1e3, c + e.count)
    return {name: dict(ms=t / c, launches=c) for name, (t, c) in out.items()}


def time_flash_bwd(K, R, gen, dev):
    """The whole backward (its three launches: delta, dK/dV, dQ) at the
    training path's shape, against the plain version and the backward of
    scaled_dot_product_attention (its autograd, timed here only), in
    alternating rounds between CUDA events (the library's backward is not
    captured in a graph, so neither is the kernel), and each launch's
    device time from the profiler (BWD_LAUNCH_MS, taken in phase_kernels).
    Bound: the five products of the causal half at the bf16 tensor-core
    rate, against q, k, v, o and dO read once and dq, dk, dv written once
    (the lse the forward hands over is not counted)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, \
        flash_attention_cuda

    dt = torch.bfloat16
    b, s, h, kv, d = TRAIN_B, TRAIN_S, H, KV, D
    q, do = randn(gen, (b, s, h, d), dt, dev), randn(gen, (b, s, h, d), dt, dev)
    k, v = randn(gen, (b, s, kv, d), dt, dev), randn(gen, (b, s, kv, d), dt, dev)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    o = flash_attention_cuda(q, k, v, lse=lse)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    ot = sdpa(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    kernel = lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse, True, None)  # noqa: E731
    library = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)  # noqa: E731
    ks, ls = [], []
    for _ in range(ROUNDS):
        ks.append(event_ms(kernel, 10))
        ls.append(event_ms(library, 10))
    ms, lib = statistics.median(ks), statistics.median(ls)
    plain = event_ms(lambda: R.flash_attention_bwd_ref(q, k, v, o, do, True, None), 2)
    lib_err = max((x.transpose(1, 2).float() - y.float()).abs().max().item()
                  for x, y in zip(library(), kernel()))
    pairs = s * (s + 1) // 2
    b_ms, b_by = bound((4 * q.numel() + 4 * k.numel()) * q.element_size(),
                       5 * 2.0 * b * h * pairs * d, dt)
    log(f"[times] flash_attention_bwd q {tuple(q.shape)} kv {tuple(k.shape)} bf16 causal: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa backward {lib:.4f} ms (|sdpa - kernel| "
        f"{lib_err:.2e}), bound {b_ms:.4f} ms ({b_by}: {5 * 2.0 * b * h * pairs * d:.3e} FLOP "
        f"at 989 TFLOP/s); {b_ms / ms:.3f} of bound")
    log(f"[times]   {ROUNDS} rounds: kernel {spread(ks)}; sdpa backward {spread(ls)}")
    launch = dict(BWD_LAUNCH_MS)
    log("[times]   each launch (profiler in phase_kernels, mean device ms over the launches "
        "it recorded): "
        + ", ".join(f"{name} {r['ms']:.4f} ({r['launches']})" for name, r in launch.items())
        + f"; sum {sum(r['ms'] for r in launch.values()):.4f}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                launch_ms=launch)


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
           "flash_attention_bwd": time_flash_bwd(K, R, gen, dev),
           "decode_attention": time_decode(K, R, gen, dev, H, KV, D)}
    time_flash(K, R, gen, dev, ZH, ZKV, ZD)
    time_decode(K, R, gen, dev, ZH, ZKV, ZD)
    time_decode(K, R, gen, dev, H, KV, D, B=MT_CAPACITY)      # the multi-tenant step's shape
    res.update(time_scans(K, R, gen, dev))
    return res


# the perception phase: scene sets (scenario, rain mm/h; the paper's Table
# IV axis), frames per set, and the card-against-CPU bounds.  Both devices
# compute in f32 from the same weights; the boxes differ only by the
# convolutions' summation order (~1e-5 px), so 1e-3 px is far above that
# noise and far below a shifted window or a reordered detection.  A box
# within 1e-3 px moves an IoU by at most 4e-3 / 8 (boxes are 8 px or more),
# which bounds the calibrated qualities.
PERCEPTION_SCENES = [("city", 0.0), ("residential", 0.0), ("road", 0.0), ("city", 50.0)]
PERCEPTION_FRAMES = 24
BOX_TOL_PX = 1e-3
QUALITY_TOL = 5e-4
ANYTIME_FRAMES, ANYTIME_CAL = 40, 12
# each pipeline's threshold on its device output (leaf index, threshold):
# the value that decides a count when the two devices disagree
DECIDING = {"one_stage": (1, 0.5), "early_exit": (1, 0.5), "two_stage": (1, 0.55),
            "lane": (0, 0.6)}


def _leaves(out) -> list:
    return [out] if isinstance(out, np.ndarray) else list(out)


def _explain(pipe, cuda_built, cpu_built, scene):
    """One frame's device outputs on both sides, and each value on opposite
    sides of the pipeline's threshold, printed beside it."""
    from repro_torch.core.timing import fence, to_host
    from repro_torch.perception import preprocess

    img = preprocess(scene.image, cuda_built.scale, cuda_built.pad)
    outs = []
    for built in (cuda_built, cpu_built):
        out = built.infer(torch.from_numpy(img).to(built.device))
        fence(out)
        outs.append(_leaves(to_host(out)))
    for i, (a, b) in enumerate(zip(*outs)):
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64)).max() if a.size else 0.0
        log(f"[perception]   {pipe} output {i} {a.shape} {a.dtype}: max |card - cpu| {diff:.3e}")
    if pipe in DECIDING:
        leaf, thr = DECIDING[pipe]
        a, b = outs[0][leaf], outs[1][leaf]
        for pos in zip(*np.nonzero((a > thr) != (b > thr))):
            log(f"[perception]   deciding value at {pos}: card {a[pos]!r}, cpu {b[pos]!r}, "
                f"threshold {thr}")


def _compare_frames(label, pipe, where, got, want, cuda_built, cpu_built) -> float:
    """Card against CPU, frame by frame; the largest box difference."""
    worst = 0.0
    for i, ((scene, g), (_, w)) in enumerate(zip(got, want)):
        same_shape = g.boxes.shape == w.boxes.shape
        err = float(np.abs(g.boxes - w.boxes).max()) if same_shape and g.boxes.size else 0.0
        counts = (g.num_proposals, g.num_objects), (w.num_proposals, w.num_objects)
        if counts[0] != counts[1] or not same_shape or not err <= BOX_TOL_PX:
            log(f"[perception] {label} {where} frame {i + 1}: card (proposals, objects) "
                f"{counts[0]} boxes {g.boxes.shape}, cpu {counts[1]} boxes {w.boxes.shape}, "
                f"max |box diff| {err:.3e} px (bound {BOX_TOL_PX})")
            _explain(pipe, cuda_built, cpu_built, scene)
            raise AssertionError(f"perception: {label} {where} frame {i + 1}: card and CPU "
                                 f"disagree")
        worst = max(worst, err)
    return worst


def _ms(summary) -> str:
    return f"{summary.mean * 1e3:.4f} / {summary.cv:.3f} / {summary.p99 * 1e3:.4f}"


def _profile_inference(built, scenes, infer_mean_s):
    """Launches per frame and the device's busy share of the inference
    stage: the stage's body (host-to-device copy, device pass, fence) over
    the frames under torch.profiler; busy = device time per frame over the
    unprofiled stage mean."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.timing import fence
    from repro_torch.perception import preprocess

    imgs = [preprocess(sc.image, built.scale, built.pad) for sc in scenes]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for img in imgs:
            fence(built.infer(torch.from_numpy(img).to(built.device)))
    kernels = copies = 0
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU or _device_us(e) <= 0:
            continue
        busy_us += _device_us(e)
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.count
        else:
            kernels += e.count
    n = len(imgs)
    busy_ms = busy_us / 1e3 / n
    return kernels / n, copies / n, busy_ms, busy_ms / (infer_mean_s * 1e3)


def phase_perception(dev):
    """The perception frame path on the card against the CPU, its stage
    times, launches and device share, and the anytime A/B (module
    docstring, phase 5)."""
    from repro_torch import anytime as A
    from repro_torch import kernels as K
    from repro_torch.core.stats import pearson
    from repro_torch.perception import PIPELINES, SceneConfig, build_pipeline, run_pipeline

    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True        # torch's default
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        builds = [(name, name, 1.0, True) for name in PIPELINES]
        builds += [(f"{r.name} rung", r.pipeline, r.scale, False) for r in A.default_rungs()]
        recs = {}
        n_frames, worst = 0, 0.0
        for label, pipe, scale, pad in builds:
            cuda_built = build_pipeline(pipe, scale=scale, pad=pad, device=dev)
            cpu_built = build_pipeline(pipe, scale=scale, pad=pad, device="cpu")
            for scenario, rain in PERCEPTION_SCENES:
                cfg = SceneConfig(scenario, rain)
                where = f"{scenario} rain {rain:g}"
                rec, got = run_pipeline(pipe, cfg, n=PERCEPTION_FRAMES, collect=True,
                                        built=cuda_built)
                _, want = run_pipeline(pipe, cfg, n=PERCEPTION_FRAMES, collect=True,
                                       built=cpu_built)
                worst = max(worst, _compare_frames(label, pipe, where, got, want, cuda_built,
                                                   cpu_built))
                n_frames += len(got)
                recs[(label, where)] = (rec, got, cuda_built)
        log(f"[perception] card against CPU: {len(builds)} builds x {len(PERCEPTION_SCENES)} "
            f"scene sets x {PERCEPTION_FRAMES} frames = {n_frames} frames on each device; "
            f"proposal and object counts equal on every frame, boxes within {worst:.3e} px "
            f"(bound {BOX_TOL_PX} px); cuDNN TF32 at torch's default")

        # ---- stage times on the card, lambda = 1
        log("[perception] stage times on the card, ms, mean / CV / p99: read, pre_processing, "
            "inference, post_processing; end to end")
        for name in PIPELINES:
            for scenario, rain in PERCEPTION_SCENES:
                where = f"{scenario} rain {rain:g}"
                rec = recs[(name, where)][0]
                stages = "; ".join(f"{st} {_ms(rec.summary(st))}" for st in rec.stages())
                log(f"[perception]   {name:11s} {where:16s} {stages}; e2e {_ms(rec.summary())}")
        for name in ("two_stage", "lane"):
            post, props = [], []
            for scenario, rain in PERCEPTION_SCENES:
                rec = recs[(name, f"{scenario} rain {rain:g}")][0]
                p = rec.meta_series("num_proposals")
                r = pearson(rec.stage_series("post_processing"), p)
                log(f"[perception] {name} {scenario} rain {rain:g}: Pearson r(post_processing, "
                    f"num_proposals) = {r:.3f}, proposals {p.min():.0f}-{p.max():.0f}")
                post.extend(rec.stage_series("post_processing"))
                props.extend(p)
            log(f"[perception] {name} all {len(post)} frames: Pearson r(post_processing, "
                f"num_proposals) = {pearson(post, props):.3f}")

        # ---- launches per frame and the device's share of the inference stage
        for label, pipe, scale, pad in builds:
            rec, got, built = recs[(label, "city rain 0")]
            infer_s = float(rec.stage_series("inference").mean())
            kernels, copies, busy_ms, share = _profile_inference(built, [sc for sc, _ in got],
                                                                 infer_s)
            log(f"[perception] {label:20s} city: {kernels:.1f} kernel launches + {copies:.1f} "
                f"copies per frame; device busy {busy_ms:.4f} ms of the inference stage's "
                f"{infer_s * 1e3:.4f} ms ({share:.3f} busy, {1 - share:.3f} idle)")

        # ---- the anytime A/B, as benchmarks/anytime.py runs it
        cfg = SceneConfig("city", seed=3)
        rungs = A.default_rungs()
        built = A.build_rungs(rungs, cfg, device=dev)
        ladder = A.calibrate(rungs, cfg, n=ANYTIME_CAL, built=built)
        cpu_ladder = A.calibrate(rungs, cfg, n=ANYTIME_CAL, device="cpu")
        for r in ladder:
            log(f"[anytime] rung {r.name:15s} quality {r.quality:.6f} e2e mean "
                f"{r.e2e_mean * 1e3:.4f} ms (" + ", ".join(
                    f"{k} {v * 1e3:.4f}" for k, v in r.stage_means.items()) + ")")
        order, cpu_order = [r.name for r in ladder], [r.name for r in cpu_ladder]
        dq = max(abs(a.quality - b.quality) for a, b in zip(ladder, cpu_ladder))
        log(f"[anytime] calibrated order {order}; CPU order {cpu_order}; max |quality card - "
            f"cpu| {dq:.3e} (bound {QUALITY_TOL})")
        if order != cpu_order or not dq <= QUALITY_TOL:
            raise AssertionError("anytime: the card's calibrated ladder differs from the CPU's")
        top = ladder.top
        for label, mult in (("tight", 0.5), ("mid", 1.0), ("loose", 2.5)):
            budget = mult * top.e2e_mean
            arms = {f"static[{top.name}]": A.FixedController(ladder),
                    f"static[{ladder.floor.name}]": A.FixedController(ladder, ladder.floor.name),
                    "contract": A.ContractController(ladder)}
            for arm, ctl in arms.items():
                rep = A.run_anytime(ladder, cfg, budget, controller=ctl, n=ANYTIME_FRAMES,
                                    built=built)
                if len(rep.frames) != ANYTIME_FRAMES or not math.isfinite(rep.p99_latency):
                    raise AssertionError(f"anytime {label} {arm}: bad report")
                log(f"[anytime] {label} budget {budget * 1e3:.4f} ms {arm:24s} miss "
                    f"{rep.miss_rate * 100:5.1f} %  quality {rep.mean_quality:.4f}  mean "
                    f"{rep.mean_latency * 1e3:.4f} ms  p99 {rep.p99_latency * 1e3:.4f} ms  "
                    f"switches {rep.switches}  rungs {rep.rung_counts()}")
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    counts = K.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"perception: the perception path launched kernels {counts}")
    log(f"[perception] kernel launch counters over the phase: {counts} (the path runs none "
        f"of the kernels); phase {time.perf_counter() - t0:.1f}s")


# ---- phase 6: batched multi-camera perception (repro_torch.batched)
BATCH_CAPACITY = 8
BATCH_TICKS = 3                  # card against serial and CPU, per pipeline
DEPTH_TICKS = 5                  # depth k against depth 1
PROFILE_STREAMS = (1, 2, 4, 8)
PROFILE_TICKS = 12
FPS_TICKS = 24                   # as benchmarks/batched.py
FPS_RUNGS = ("two_stage", "one_stage", "early_exit")
SCHED_TICKS = 40
SCHED_BUDGETS = (0.5, 2.5)       # x the top rung's warmed batched step


def _batched_builds():
    """(label, pipeline, scale, pad): the five ladder rungs (unpadded, as
    the scheduler builds them) and the two lane pipelines."""
    from repro_torch import anytime as A

    builds = [(r.name, r.pipeline, r.scale, False) for r in A.default_rungs()]
    return builds + [("lane", "lane", 1.0, True), ("lane_static", "lane_static", 1.0, True)]


def _stream_scenes(n_streams: int, n_ticks: int, seed0: int = 100):
    """scenes[tick][stream]: each stream a camera of its own, cycling over
    PERCEPTION_SCENES."""
    from repro_torch.perception import SceneConfig, generate_scene

    cfgs = [SceneConfig(*PERCEPTION_SCENES[s % len(PERCEPTION_SCENES)], seed=seed0 + s)
            for s in range(n_streams)]
    return [[generate_scene(cfg, t + 1) for cfg in cfgs] for t in range(n_ticks)]


def _same_frame(label, where, got, want) -> float:
    """Counts equal and boxes within BOX_TOL_PX; the largest box difference."""
    same_shape = got.boxes.shape == want.boxes.shape
    err = float(np.abs(got.boxes - want.boxes).max()) if same_shape and got.boxes.size else 0.0
    counts = (got.num_proposals, got.num_objects), (want.num_proposals, want.num_objects)
    if counts[0] != counts[1] or not same_shape or not err <= BOX_TOL_PX:
        raise AssertionError(f"batched: {label} {where}: (proposals, objects) {counts[0]} "
                             f"boxes {got.boxes.shape} against {counts[1]} {want.boxes.shape}, "
                             f"max |box diff| {err:.3e} px (bound {BOX_TOL_PX})")
    return err


def _executor_outputs(built, depth, frames_seq):
    """The host output tree of every tick, in submission order, from an
    executor over ``built``'s device step at ``depth`` (copies: the drained
    arrays are views of the pinned ring)."""
    from repro_torch.batched import PipelinedExecutor

    ex = PipelinedExecutor(built.device_step, BATCH_CAPACITY, frames_seq[0][0].shape,
                           depth=depth, device=built.device)
    outs = []
    for frames in frames_seq:
        ex.submit(dict(enumerate(frames)))
        if ex.ready():
            outs.append([a.copy() for a in _leaves(ex.drain().host)])
    outs += [[a.copy() for a in _leaves(d.host)] for d in ex.flush()]
    if ex.step_captures != 1 or ex.step_replays != len(frames_seq):
        raise AssertionError(f"batched: depth {depth} executor captured {ex.step_captures} "
                             f"times, replayed {ex.step_replays}")
    return outs


def _tick_profile(eng, scenes, n_ticks):
    """Host API calls, device kernels and device busy time per tick of
    ``eng`` under torch.profiler (CPU and CUDA activity)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = eng.n_active
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(n_ticks):
            eng.tick({f"cam{s}": scenes[t][s].image for s in range(n)})
        eng.flush()
        torch.cuda.synchronize()
    api, kernels, copies, busy_us = Counter(), 0, 0, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            if e.key.startswith("cuda"):
                api[e.key] += e.count
        elif _device_us(e) > 0:
            busy_us += _device_us(e)
            if e.key.startswith(("Memcpy", "Memset")):
                copies += e.count
            else:
                kernels += e.count
    return ({k: v / n_ticks for k, v in api.items()}, kernels / n_ticks, copies / n_ticks,
            busy_us / 1e3 / n_ticks)


def _tick_wall_ms(eng, scenes, n_ticks) -> float:
    """Host wall per tick over ``n_ticks`` (pipeline drained at the end)."""
    n = eng.n_active
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n_ticks):
        eng.tick({f"cam{s}": scenes[t][s].image for s in range(n)})
    eng.flush()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_ticks


def phase_batched(dev):
    """Batched multi-camera perception on the card (module docstring,
    phase 6)."""
    from repro_torch import anytime as A
    from repro_torch import kernels as K
    from repro_torch.anytime.cost import SceneFeatures
    from repro_torch.batched import BatchedPerceptionEngine, RungBucketScheduler
    from repro_torch.perception import SceneConfig, build_pipeline, generate_scene, run_frame

    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True        # torch's default, as phase 5
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        # ---- the card's engine against the serial run_frame and the CPU engine
        scenes = _stream_scenes(BATCH_CAPACITY, BATCH_TICKS)
        worst = {"serial": 0.0, "cpu": 0.0}
        for label, pipe, scale, pad in _batched_builds():
            engines = {d: BatchedPerceptionEngine(pipe, capacity=BATCH_CAPACITY, scale=scale,
                                                  pad=pad, device=d) for d in (dev, "cpu")}
            for eng in engines.values():
                for s in range(BATCH_CAPACITY):
                    eng.join(f"cam{s}")
            card = engines[dev]
            for t, tick in enumerate(scenes):
                frames = {f"cam{s}": sc.image for s, sc in enumerate(tick)}
                _, got = card.tick(frames)
                _, cpu = engines["cpu"].tick(frames)
                for s, sc in enumerate(tick):
                    where = f"tick {t} cam{s} ({sc.scenario} rain {sc.rain:g})"
                    _, serial = run_frame(card.built, sc)
                    worst["serial"] = max(worst["serial"], _same_frame(
                        label, where + " card engine vs card run_frame", got[f"cam{s}"], serial))
                    worst["cpu"] = max(worst["cpu"], _same_frame(
                        label, where + " card engine vs cpu engine", got[f"cam{s}"],
                        cpu[f"cam{s}"]))
            if card.trace_count != 1 or card.replay_count != BATCH_TICKS:
                raise AssertionError(f"batched: {label} captured {card.trace_count} times, "
                                     f"replayed {card.replay_count}")
            if label == "lane_static":
                log("[batched] lane_static's step (torch.linalg.solve_ex on (8, 4) 3 x 3 "
                    "systems) is captured in the CUDA graph and replayed")
        log(f"[batched] card engine (capacity {BATCH_CAPACITY}) against the serial run_frame "
            f"on the card and the CPU engine: {len(_batched_builds())} pipelines x "
            f"{BATCH_TICKS} ticks x {BATCH_CAPACITY} streams; counts equal on every frame, "
            f"boxes within {worst['serial']:.3e} px of serial and {worst['cpu']:.3e} px of the "
            f"CPU (bound {BOX_TOL_PX}); one capture per engine")

        # ---- depth k against depth 1, bit for bit
        frames_seq = [[sc.image for sc in tick]
                      for tick in _stream_scenes(BATCH_CAPACITY, DEPTH_TICKS, seed0=300)]
        for label, pipe, scale, pad in _batched_builds():
            built = build_pipeline(pipe, scale=scale, pad=pad, device=dev)
            want = _executor_outputs(built, 1, frames_seq)
            for depth in (2, 3):
                got = _executor_outputs(built, depth, frames_seq)
                if len(got) != len(want) or not all(
                        all(np.array_equal(a, b) for a, b in zip(g, w))
                        for g, w in zip(got, want)):
                    raise AssertionError(f"batched: {label} depth {depth} differs from depth 1")
        log(f"[batched] depths 2 and 3 equal depth 1 bit for bit: {len(_batched_builds())} "
            f"pipelines x {DEPTH_TICKS} ticks, every output leaf")

        # ---- churn: one capture, one replay a tick, no sync on the tick path
        img = generate_scene(SceneConfig("city", seed=21), 1).image
        eng = BatchedPerceptionEngine("early_exit", capacity=4, device=dev)
        eng.compile()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.join("a")
            eng.join("b")
            eng.tick({"a": img, "b": img})
            eng.join("c")
            eng.tick({"a": img, "b": img, "c": img})
            eng.leave("b")
            eng.tick({"a": img, "c": img})
            eng.leave("a")
            eng.leave("c")
            eng.join("d")
            eng.tick({"d": img})
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ex = eng.executor
        if (eng.trace_count, eng.replay_count, eng.ticks) != (1, 4, 4):
            raise AssertionError(f"batched churn: captures {eng.trace_count}, replays "
                                 f"{eng.replay_count}, ticks {eng.ticks}")
        log(f"[batched] churn (join, join mid-run, leave, rejoin): step_captures "
            f"{ex.step_captures}, step_replays {ex.step_replays} == ticks {eng.ticks}; the "
            f"ticks ran under torch.cuda.set_sync_debug_mode('error') (the drain's event wait "
            f"is the only wait); staging waits {ex.stage_waits}")

        # ---- per-tick launches and the device's busy share, per rung
        log("[batched] per tick (capacity 8 engine): host API calls (graph launches, "
            "copies, others), device kernels and copies, device busy ms of the tick's wall ms")
        prof_scenes = _stream_scenes(BATCH_CAPACITY, PROFILE_TICKS, seed0=400)
        for label, pipe, scale, pad in _batched_builds()[:5]:
            for depth in (1, 2):
                eng = BatchedPerceptionEngine(pipe, capacity=BATCH_CAPACITY, scale=scale,
                                              pad=pad, depth=depth, device=dev)
                for n in PROFILE_STREAMS:
                    eng.reset()
                    for s in range(n):
                        eng.join(f"cam{s}")
                    _tick_wall_ms(eng, prof_scenes, 2)                    # warm
                    wall = _tick_wall_ms(eng, prof_scenes, PROFILE_TICKS)
                    api, kernels, copies, busy = _tick_profile(eng, prof_scenes, PROFILE_TICKS)
                    graphs = sum(v for k, v in api.items() if "GraphLaunch" in k)
                    memcpy = sum(v for k, v in api.items() if "Memcpy" in k)
                    others = sum(api.values()) - graphs - memcpy
                    log(f"[batched]   {label:15s} depth {depth} streams {n}: {graphs:.1f} graph "
                        f"launches + {memcpy:.1f} copies + {others:.1f} other calls a tick; "
                        f"device {kernels:.1f} kernels + {copies:.1f} copies, busy {busy:.4f} "
                        f"ms of {wall:.4f} ms ({busy / wall:.3f} busy)")
                log(f"[batched]   {label} depth {depth} host API calls a tick at 8 streams: "
                    + ", ".join(f"{k} {v:.1f}" for k, v in sorted(api.items())))

        # ---- frames/s: the batched engine against the serial run_frame loop
        for rung in FPS_RUNGS:
            built = build_pipeline(rung, device=dev)
            run_frame(built, generate_scene(SceneConfig("city", seed=100), 0))
            for n in PROFILE_STREAMS:
                fps_scenes = _stream_scenes(n, FPS_TICKS)
                eng = BatchedPerceptionEngine(built, capacity=n)
                for s in range(n):
                    eng.join(f"cam{s}")
                eng.compile()
                sw, bw = [], []
                for tick in fps_scenes:
                    t1 = time.perf_counter()
                    for sc in tick:
                        run_frame(built, sc)
                    sw.append(time.perf_counter() - t1)
                    t1 = time.perf_counter()
                    eng.tick({f"cam{s}": sc.image for s, sc in enumerate(tick)})
                    bw.append(time.perf_counter() - t1)
                sw, bw = np.asarray(sw), np.asarray(bw)
                log(f"[batched] frames/s {rung:10s} streams {n}: serial run_frame "
                    f"{n / np.median(sw):9.1f}, batched engine {n / np.median(bw):9.1f}, "
                    f"median paired speedup {np.median(sw / bw):.2f}x "
                    f"({FPS_TICKS} ticks; captures {eng.trace_count})")

        # ---- the rung-bucket scheduler: 4 tight and 4 loose streams
        cfg = SceneConfig("city", seed=3)
        rungs = A.default_rungs()
        ladder = A.calibrate(rungs, cfg, n=ANYTIME_CAL, built=A.build_rungs(rungs, cfg, device=dev))
        # frames made ahead, as a camera delivers them: at depth 2 a frame
        # completes a tick after its submit, so the loop's own work between
        # ticks would count in its latency
        sched_scenes = _stream_scenes(BATCH_CAPACITY, SCHED_TICKS, seed0=200)
        for depth in (1, 2):
            sched = RungBucketScheduler(ladder, capacity=BATCH_CAPACITY, depth=depth, device=dev)
            sched.warm()
            step = {name: sched.engines[name].probe(
                [generate_scene(SceneConfig(), i).image for i in range(BATCH_CAPACITY)]
            ).end_to_end for name in (ladder.top.name, ladder.floor.name)}
            top_ms = step[ladder.top.name]
            log(f"[sched] depth {depth}: batched step at capacity {BATCH_CAPACITY}: top "
                f"{ladder.top.name} {top_ms * 1e3:.4f} ms, floor {ladder.floor.name} "
                f"{step[ladder.floor.name] * 1e3:.4f} ms (floor / top "
                f"{step[ladder.floor.name] / top_ms:.3f}); serial calibration: top "
                f"{ladder.top.e2e_mean * 1e3:.4f} ms, floor {ladder.floor.e2e_mean * 1e3:.4f} ms")
            groups = {}
            for s in range(BATCH_CAPACITY):
                mult = SCHED_BUDGETS[0] if s < BATCH_CAPACITY // 2 else SCHED_BUDGETS[1]
                groups[f"cam{s}"] = mult
                sched.add_stream(f"cam{s}", mult * top_ms)
            sizes: dict[str, list[int]] = {}
            for scenes in sched_scenes:
                res = sched.tick(dict(zip(groups, scenes)))
                for rname, members in res.buckets.items():
                    sizes.setdefault(rname, []).append(len(members))
            sched.flush()
            if any(e.trace_count != 1 for e in sched.engines.values()):
                raise AssertionError("scheduler: an engine captured more than once")
            report = {r["stream"]: r for r in sched.report()}
            for mult in SCHED_BUDGETS:
                rows = [r for sid, r in report.items() if groups[sid] == mult]
                if any(r["frames"] != SCHED_TICKS for r in rows):
                    raise AssertionError(f"scheduler: frames lost: {rows}")
                log(f"[sched] depth {depth} budget {mult} x top ({mult * top_ms * 1e3:.4f} ms): "
                    f"miss {np.mean([r['miss_rate'] for r in rows]) * 100:.1f} %, quality "
                    f"{np.mean([r['mean_quality'] for r in rows]):.4f}, switches "
                    f"{sum(r['switches'] for r in rows)}")
            log(f"[sched] depth {depth} bucket sizes over {SCHED_TICKS} ticks (mean, ticks "
                f"served): " + ", ".join(f"{k} {np.mean(v):.2f} x {len(v)}"
                                         for k, v in sorted(sizes.items())))
            feats = SceneFeatures(batch_size=4.0, batched=True, pipeline_depth=float(depth))
            log(f"[sched] depth {depth} learned batched cost at 4 streams: " + ", ".join(
                f"{r.name} {sched.cost.predict(r.name, feats).mean * 1e3:.4f} ms"
                for r in ladder))
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
        torch.cuda.set_sync_debug_mode("default")
    counts = K.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"batched: the batched path launched kernels {counts}")
    log(f"[batched] kernel launch counters over the phase: {counts}; phase "
        f"{time.perf_counter() - t0:.1f}s")


# ---- phase 7: scenario replay (repro_torch.scenarios) and the obs CLI
GOLDEN_DIR = Path(__file__).resolve().parent / "tests" / "golden"
FLEET_STREAMS, FLEET_TICKS = 8, 40      # as launch/serve.py --fleet's defaults
# card against CPU: every count, rung histogram and modeled latency equal,
# mean_quality within QUALITY_TOL
REPLAY_TOL = dict(rel=0.0, abs_ms=0.0, rate=0.0, quality=QUALITY_TOL, count_frac=0.0, count_abs=0)


class TickLoopGuard:
    """The replayer's ``sentinel``: wall time of the episode's tick loop
    alone (the warm-up with its captures happens before it is entered),
    run under ``torch.cuda.set_sync_debug_mode("error")`` so any implicit
    host synchronisation in a tick raises."""

    def __init__(self):
        self.seconds = 0.0

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self._t0
        return False


def phase_scenarios(dev):
    """Golden-episode replay on the card against the CPU, one capture per
    engine across episodes, the obs contract on the card, the card's
    report against tests/golden, and a one-shard fleet run (module
    docstring, phase 7)."""
    import argparse

    from repro_torch import kernels as K
    from repro_torch.launch.serve import serve_fleet
    from repro_torch.obs.__main__ import main as obs_main
    from repro_torch.scenarios import Tolerance, compare_reports, golden_replay
    from repro_torch.scenarios.golden import GOLDEN_EPISODES, golden_path

    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True        # torch's default, as phases 5 and 6
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        reports, loops, scheds = {}, {}, {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            sched = None
            for name in GOLDEN_EPISODES:
                guard = TickLoopGuard() if where == "card" else None
                rep, sched = golden_replay(name, scheduler=sched, sentinel=guard,
                                           device=None if sched else d)
                reports[(where, name)] = rep
                if guard is not None:
                    loops[name] = guard.seconds
            scheds[where] = sched
        for name in GOLDEN_EPISODES:
            card, cpu = reports[("card", name)], reports[("cpu", name)]
            problems = compare_reports(card.to_dict(), cpu.to_dict(), Tolerance(**REPLAY_TOL))
            if problems:
                raise AssertionError(f"scenarios: {name} card replay differs from the CPU's: "
                                     + "; ".join(problems[:5]))
            dq = max((abs(a - b) for a, b in _quality_pairs(card.to_dict(), cpu.to_dict())),
                     default=0.0)
            tot = card.totals()
            want = json.loads(golden_path(GOLDEN_DIR, name).read_text())
            n_golden = len(compare_reports(card.to_dict(), want))
            log(f"[scenarios] {name}: card equals CPU on {tot['frames']} frames "
                f"({len(card.segments)} segments, rungs {tot['rung_hist']}, misses "
                f"{tot['misses']}, clock {card.clock_s:.6f} s virtual); max |mean_quality "
                f"card - cpu| {dq:.3e} (bound {QUALITY_TOL}); tick loop {loops[name]:.3f} s wall "
                f"for {card.n_ticks} ticks ({loops[name] / card.n_ticks * 1e3:.3f} ms a tick) "
                f"under set_sync_debug_mode('error'); {n_golden} violation(s) of "
                f"tests/golden/{name}.json with the port's seed-7 weights (information)")
        caps = {n: e.executor.step_captures for n, e in scheds["card"].engines.items()}
        if any(c != 1 for c in caps.values()):
            raise AssertionError(f"scenarios: the reused scheduler captured again: {caps}")
        log(f"[scenarios] one scheduler across {len(GOLDEN_EPISODES)} episodes: step_captures "
            f"per engine {caps}, replays "
            f"{ {n: e.executor.step_replays for n, e in scheds['card'].engines.items()} }")

        # ---- the obs contract on the card
        if obs_main(["--episode", "urban_rush_hour", "--device", str(dev)]) != 0:
            raise AssertionError("scenarios: the obs contract failed on the card")

        # ---- one-shard fleet, as launch/serve.py --fleet runs it
        doc = serve_fleet(argparse.Namespace(batch=4, streams=FLEET_STREAMS, ticks=FLEET_TICKS,
                                             obs=False, slo_ms=None, json_out=None,
                                             trace_out=None, device=str(dev)))
        if doc["frames"] != FLEET_STREAMS * FLEET_TICKS or any(
                c > 1 for c in doc["trace_counts"].values()):
            raise AssertionError(f"fleet: {doc['frames']} frames, captures {doc['trace_counts']}")
        log(f"[fleet] {FLEET_STREAMS} streams x {FLEET_TICKS} ticks, one shard: "
            f"{doc['frames_per_vs']:.3f} frames per virtual second, {doc['wall_s']:.3f} s wall "
            f"({doc['frames'] / doc['wall_s']:.1f} frames per wall second)")
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
        torch.cuda.set_sync_debug_mode("default")
    counts = K.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"scenarios: the replay path launched kernels {counts}")
    log(f"[scenarios] kernel launch counters over the phase: {counts}; phase "
        f"{time.perf_counter() - t0:.1f}s")


def _quality_pairs(got: dict, want: dict):
    """(got, want) for every non-null mean_quality leaf of two reports."""
    if isinstance(want, dict):
        for k, w in want.items():
            if k == "mean_quality" and w is not None:
                yield got[k], w
            else:
                yield from _quality_pairs(got[k], w)
    elif isinstance(want, list):
        for g, w in zip(got, want):
            yield from _quality_pairs(g, w)


# ---- phase 8: multi-tenant continuous-batching decode (repro_torch.runtime)
MT_CAPACITY, MT_CONTEXT, MT_STREAMS, MT_RATE = 8, 1024, 16, 100.0
MT_PROMPT, MT_NEW = 64, 32
MT_PROFILE_STEPS = 4
CARVE_PROMPT, CARVE_NEW = 16, 16        # rwkv6-3b slot reuse at capacity 1


def _drain_tokens(eng, requests):
    """Queue every request, then drain: the seating order does not depend
    on measured latency.  Returns per-tenant (slot, tokens, ramp steps)."""
    from repro_torch.runtime import RequestQueue

    q = RequestQueue()
    for r in requests:
        q.push(r)
    eng.compile()
    eng.drain(q)
    return {t.req.tenant: (t.slot, list(map(int, t.generated)), t.ramp_steps)
            for t in eng.finished}


def _step_busy(eng, model, n_steps):
    """Device busy share of one shared step at full occupancy
    (torch.profiler): the engine is seated with long requests, warmed two
    steps, then ``n_steps`` steps are profiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import StreamRequest

    rng = np.random.default_rng(9)
    for i in range(eng.n_free):
        eng.join(StreamRequest(f"busy-{i}", rng.integers(0, model.cfg.vocab_size, 2),
                               max_new_tokens=10_000))
    for _ in range(2):
        eng.step()
    walls = []
    for _ in range(n_steps):
        walls.append(eng.step())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
    busy_us = kernels = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU and _device_us(e) > 0:
            busy_us += _device_us(e)
            kernels += e.count
    busy_ms = busy_us / 1e3 / n_steps
    wall_ms = statistics.median(walls) * 1e3
    return busy_ms, wall_ms, kernels / n_steps


def phase_multi_tenant(dev):
    """qwen3-4b multi-tenant serving at full width with its decode_attention
    launches counted, the rwkv6-3b slot carve-out at full width, and the
    smoke engines on the card against the CPU (module docstring, phase 8).
    Returns the decode_attention launches of the main path."""
    from repro_torch import kernels as K
    from repro_torch.bus import Broker, CopyTransport, SimClock
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime import (AdmissionController, AlwaysAdmit, MultiTenantConfig,
                                     MultiTenantEngine, RequestQueue, StreamRequest,
                                     poisson_workload)

    t0 = time.perf_counter()
    # ---- smoke, f32: the same queued workload on the card and the CPU
    for arch in ("qwen3-4b", "rwkv6-3b"):
        small = Model(get_config(arch, smoke=True))
        p_cpu = small.init(seed=1, device="cpu")
        work = poisson_workload(7, MT_RATE, small.cfg.vocab_size, prompt_len=8,
                                max_new_tokens=12, seed=2)
        got = {}
        for where, d, params in (("cpu", torch.device("cpu"), p_cpu),
                                 ("card", dev, to_device(p_cpu, dev))):
            eng = MultiTenantEngine(small, params, MultiTenantConfig(3, 64),
                                    admission=AlwaysAdmit(), device=d)
            got[where] = _drain_tokens(eng, work)
        if got["card"] != got["cpu"]:
            raise AssertionError(f"multi-tenant smoke {arch}: card tokens differ from the CPU's")
        log(f"[multi_tenant] smoke {arch} f32: {len(got['cpu'])} tenants, capacity 3, the same "
            f"slots, ramp steps and {sum(len(v[1]) for v in got['cpu'].values())} generated "
            f"tokens on the card as on the CPU")

    # ---- qwen3-4b at full width, bf16: Poisson arrivals through the broker
    cfg = get_config("qwen3-4b")
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    clock = SimClock()
    broker = Broker(transport=CopyTransport(), seed=0)
    queue = RequestQueue()
    broker.subscribe("requests", callback=lambda env: queue.push(env.payload), queue_size=0)
    for req in poisson_workload(MT_STREAMS, MT_RATE, cfg.vocab_size, prompt_len=MT_PROMPT,
                                max_new_tokens=MT_NEW, seed=0):
        broker.publish("requests", req, size_bytes=4 * req.prompt.size, now=req.arrival_s)
    eng = MultiTenantEngine(model, params, MultiTenantConfig(MT_CAPACITY, MT_CONTEXT),
                            admission=AdmissionController(confidence=0.95), device=dev)
    eng.compile()
    torch.cuda.synchronize()
    # ---- the main path, with the launch counters read around it
    K.reset_launch_counts()
    t1 = time.perf_counter()
    eng.drain(queue, clock=clock, source=broker)
    wall = time.perf_counter() - t1
    counts = K.launch_counts()
    # ----
    agg = eng.aggregate_report()
    want = {name: 0 for name in KERNELS}
    want["decode_attention"] = agg["steps"] * cfg.num_layers
    if counts != want:
        raise AssertionError(f"multi-tenant: launches {counts}, expected {want}")
    if agg["traces"] != 1:
        raise AssertionError(f"multi-tenant: the step was built {agg['traces']} times")
    rows = eng.per_tenant_report()
    if len(rows) != MT_STREAMS or any(r["status"] not in ("finished", "shed") for r in rows):
        raise AssertionError(f"multi-tenant: tenants not all finished or shed: {rows}")
    tokens = sum(r["tokens"] for r in rows)
    log(f"[multi_tenant] qwen3-4b full width bf16, capacity {MT_CAPACITY}, context {MT_CONTEXT}, "
        f"{MT_STREAMS} Poisson streams at {MT_RATE:g} Hz (prompt {MT_PROMPT}, {MT_NEW} new "
        f"tokens), AdmissionController, mean deadline: {agg['steps']} steps, "
        f"{agg['streams']} served, {agg['shed_streams']} shed, traces {agg['traces']}; "
        f"launches {counts} = steps x {cfg.num_layers}")
    log(f"[multi_tenant] step mean {agg['step_mean_s'] * 1e3:.3f} ms cv {agg['step_cv']:.3f} p99 "
        f"{agg['step_p99_s'] * 1e3:.3f} ms; {tokens} tokens in {wall:.3f} s wall of the drain "
        f"({tokens / wall:.1f} tokens/s, prompt feeding not counted); {clock.time():.3f} s "
        f"simulated; jobs {agg['jobs']}, miss rate {agg['miss_rate']:.3f}")
    log(f"[multi_tenant] {'tenant':>10s} {'status':>9s} {'jobs':>5s} {'mean_ms':>8s} {'cv':>6s} "
        f"{'p99_ms':>8s} {'miss%':>6s}")
    for r in rows:
        log(f"[multi_tenant] {r['tenant']:>10s} {r['status']:>9s} {r['jobs']:>5d} "
            f"{r['mean_s'] * 1e3:8.3f} {r['cv']:6.3f} {r['p99_s'] * 1e3:8.3f} "
            f"{r['miss_rate'] * 100:6.2f}")
    busy_ms, wall_ms, kernels = _step_busy(eng, model, MT_PROFILE_STEPS)
    log(f"[multi_tenant] one step at {MT_CAPACITY} tenants: device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall ({busy_ms / wall_ms:.3f} busy, {1 - busy_ms / wall_ms:.3f} "
        f"idle), {kernels:.1f} device kernels and copies (torch.profiler)")
    del eng, params, model
    torch.cuda.empty_cache()

    # ---- rwkv6-3b at full width, capacity 1: a tenant that follows another
    # in the slot generates what it generates in a fresh engine
    model = Model(get_config("rwkv6-3b"))
    params = model.init(seed=0, device=dev)
    rng = np.random.default_rng(5)
    first, second = (StreamRequest(name, rng.integers(0, model.cfg.vocab_size, CARVE_PROMPT),
                                   max_new_tokens=CARVE_NEW) for name in ("first", "second"))
    reused = _drain_tokens(MultiTenantEngine(model, params, MultiTenantConfig(1, MT_CONTEXT),
                                             device=dev), [first, second])["second"]
    fresh = _drain_tokens(MultiTenantEngine(model, params, MultiTenantConfig(1, MT_CONTEXT),
                                            device=dev), [second])["second"]
    if reused != fresh:
        raise AssertionError(f"multi-tenant rwkv6-3b: slot reuse changed the tokens: "
                             f"{reused[1]} vs {fresh[1]}")
    log(f"[multi_tenant] rwkv6-3b full width bf16, capacity 1: the second tenant's "
        f"{len(fresh[1])} tokens after another tenant in the slot equal a fresh engine's "
        f"({fresh[1][:8]}...)")
    del params, model
    torch.cuda.empty_cache()
    log(f"[multi_tenant] phase {time.perf_counter() - t0:.1f}s")
    return counts["decode_attention"]


def _train_step_busy(model, params, opt_state, batch, opt_cfg, wall_s: float):
    """The device's busy share of one train step: its kernels' summed
    device time (torch.profiler) over the unprofiled step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import make_train_step

    step = make_train_step(model, opt_cfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and _device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    log(f"[train] one step under the profiler: device busy {busy_ms:.3f} ms of "
        f"{wall_s * 1e3:.3f} ms wall ({busy_ms / (wall_s * 1e3):.3f} busy, "
        f"{1 - busy_ms / (wall_s * 1e3):.3f} idle); {sum(r[2] for r in rows)} kernels")
    for key, us, count in rows[:10]:
        log(f"[train]   {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    return busy_ms / (wall_s * 1e3)


def phase_train(dev, smi: str) -> dict:
    """The training path (repro_torch.train): TRAIN_ARCH at full width and
    depth in bf16, Trainer.init and Trainer.fit over synthetic_batches
    through a PrefetchIterator (the path of launch/train.py), remat on, the
    kernels' launch counters reset just before fit and read just after:
    the flash forward 2L a step (the forward and remat's recomputation),
    the backward kernel L, nothing else.  Checks: the first step's loss
    against a no-grad Model.loss of the same batch (bf16 band: 4e-3
    relative), every loss finite and the last below the first.  Prints the
    step time (mean, CV, p99), tokens/s, the device's busy share of a step,
    peak memory and the loss per step.  Then on smoke models: a checkpoint
    round trip on the card (a trained state saved, loaded, equal bit for
    bit), and the scans' refusal to train on the card (rwkv6-3b and
    zamba2-2.7b raise NotImplementedError and launch nothing).  Returns the
    path's launch counts."""
    import tempfile

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import (AdamWConfig, DataConfig, PrefetchIterator, TrainConfig,
                                   Trainer, load_checkpoint, make_batch_np, save_checkpoint,
                                   synthetic_batches)
    from repro_torch.train.data import to_device
    from repro_torch.train.optimizer import _walk

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)
    model = Model(cfg)
    L = cfg.num_layers
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=min(20, TRAIN_STEPS // 5 + 1),
                      total_steps=TRAIN_STEPS)
    trainer = Trainer(model, dev, TrainConfig(opt=opt, log_every=1))
    params, opt_state = trainer.init(0)
    torch.cuda.synchronize()
    log(f"[train] {cfg.name} full width and depth ({L} layers, remat {cfg.remat}, loss_chunk "
        f"{cfg.loss_chunk}), bf16 weights and f32 AdamW moments: {model.num_params() / 1e9:.3f}B "
        f"params; {torch.cuda.memory_allocated() / 1e9:.1f} GB allocated after init "
        f"({time.perf_counter() - t0:.1f}s); card {smi}")
    data = DataConfig(batch=TRAIN_B, seq_len=TRAIN_S)
    with torch.no_grad():
        ref_loss, _ = model.loss(params, to_device(make_batch_np(cfg, data, 0), dev))
    ref_loss = ref_loss.item()

    losses = []
    batches = PrefetchIterator(synthetic_batches(cfg, data))
    # ---- the main path, with the launch counters read around it
    K.reset_launch_counts()
    t1 = time.perf_counter()
    params, opt_state = trainer.fit(params, opt_state, batches, TRAIN_STEPS,
                                    log=lambda i, m: losses.append(m))
    fit_s = time.perf_counter() - t1
    counts = K.launch_counts()
    # ----
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_attention=TRAIN_STEPS * 2 * L, flash_attention_bwd=TRAIN_STEPS * L)
    if counts != want:
        raise AssertionError(f"train: launches {counts}, expected {want}")
    loss = [m["loss"] for m in losses]
    for i, m in enumerate(losses):
        log(f"[train] step {i} loss={m['loss']:.6f} ce={m['ce']:.6f} lr={m['lr']:.3e} "
            f"gnorm={m['grad_norm']:.4f}")
    if not all(math.isfinite(x) for x in loss) or not loss[-1] < loss[0]:
        raise AssertionError(f"train: losses {loss} not finite or not decreasing")
    if not abs(loss[0] - ref_loss) <= 4e-3 * abs(ref_loss):
        raise AssertionError(f"train: first step's loss {loss[0]} vs no-grad Model.loss "
                             f"{ref_loss}")
    s = trainer.latency_summary()
    toks = TRAIN_B * TRAIN_S
    log(f"[train] launches on the main path over {TRAIN_STEPS} steps: {counts} (a step: "
        f"flash_attention {2 * L} = forward + remat recompute, flash_attention_bwd {L})")
    log(f"[train] first step's loss {loss[0]:.6f} vs no-grad Model.loss of the same batch "
        f"{ref_loss:.6f} (|diff| {abs(loss[0] - ref_loss):.2e}; band 4e-3 relative)")
    log(f"[train] train_step ({TRAIN_B} x {TRAIN_S} tokens, {s.n} steps after the first): "
        f"mean {s.mean * 1e3:.3f} ms cv {s.cv:.4f} p99 {s.p99 * 1e3:.3f} ms -> "
        f"{toks / s.mean:.1f} tokens/s; fit {fit_s:.3f}s; peak memory "
        f"{peak / 1e9:.3f} GB (torch.cuda.max_memory_allocated); card {smi}")
    batch = to_device(make_batch_np(cfg, data, TRAIN_STEPS), dev)
    busy = _train_step_busy(model, params, opt_state, batch, opt, s.mean)
    del params, opt_state, trainer, batch
    torch.cuda.empty_cache()

    # ---- smoke: a checkpoint round trip on the card
    small = Model(get_config(TRAIN_ARCH, smoke=True))
    tr = Trainer(small, dev, TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                                         total_steps=4)))
    p_s, o_s = tr.init(1)
    p_s, o_s = tr.fit(p_s, o_s, synthetic_batches(small.cfg, DataConfig(2, 64)), 2)
    tree = {"params": p_s, "opt": o_s}
    with tempfile.TemporaryDirectory() as d:
        where = save_checkpoint(d, 2, tree)
        template = {"params": small.init(2, device=dev), "opt": o_s._replace(step=o_s.step * 0)}
        back = load_checkpoint(d, template)
    flat = dict(_walk({"params": tree["params"], "mu": o_s.mu, "nu": o_s.nu}))
    flat_back = dict(_walk({"params": back["params"], "mu": back["opt"].mu,
                            "nu": back["opt"].nu}))
    same = all(flat_back[k].device == flat[k].device and torch.equal(flat_back[k], flat[k].detach())
               for k in flat) and int(back["opt"].step) == 2
    if not same:
        raise AssertionError("train: the checkpoint loaded on the card differs from the saved state")
    log(f"[train] smoke checkpoint round trip on the card: {len(flat)} leaves and the step "
        f"equal bit for bit ({Path(where).name})")

    # ---- smoke: the scans refuse to train on the card, launching nothing
    for arch in ("rwkv6-3b", "zamba2-2.7b"):
        m = Model(get_config(arch, smoke=True))
        p = m.init(1, device=dev)
        for _, leaf in _walk(p):
            leaf.requires_grad_()
        K.reset_launch_counts()
        try:
            m.loss(p, to_device(make_batch_np(m.cfg, DataConfig(2, 64), 0), dev))
        except NotImplementedError as e:
            msg = str(e)
        else:
            raise AssertionError(f"train: {arch} trained on the card without a scan backward")
        scans = {k: v for k, v in K.launch_counts().items() if k in ("rwkv6_wkv", "mamba2_ssd")}
        if any(scans.values()):
            raise AssertionError(f"train: {arch} launched {scans} before raising")
        log(f"[train] {arch} smoke under grad on the card raises NotImplementedError "
            f"({msg[:70]}...); scan launches {scans}")
    torch.cuda.empty_cache()
    log(f"[train] phase {time.perf_counter() - t0:.1f}s")
    return dict(counts=counts, busy=busy, peak_gb=peak / 1e9)


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
    by_path = {name: {} for name in KERNELS}
    for arch in PATHS:
        model, params, counts, rep, batch = phase_model(dev, arch)
        for name in KERNELS:
            launches[name] += counts[name]
            by_path[name][arch] = counts[name]
        pre = prefill_ms(model, params, batch)
        what = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
        log(f"[times] {arch} Model.{'forward' if model.cfg.encoder_only else 'prefill'} "
            f"({what}): {', '.join(f'{t:.3f}' for t in pre)} ms")
        if PATHS[arch].get("profile", True):
            phase_profile(model, params, dev, rep["mean_s"], min(pre) / 1e3)
        del model, params, batch
        torch.cuda.empty_cache()
    for arch in SMOKE_ONLY:
        phase_smoke(dev, arch)
    phase_perception(dev)
    phase_batched(dev)
    phase_scenarios(dev)
    mt_decode = phase_multi_tenant(dev)
    launches["decode_attention"] += mt_decode
    for name in KERNELS:
        by_path[name]["multi_tenant"] = mt_decode if name == "decode_attention" else 0
    train = phase_train(dev, smi)
    for name in KERNELS:
        launches[name] += train["counts"][name]
        by_path[name]["train"] = train["counts"][name]
    times = phase_times(dev)

    rows = []
    for name, (source, replaces) in SOURCES.items():
        t = times[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{source}",
                     "replaces": f"src/repro/{replaces}",
                     "launches": launches[name], "max_abs_err": errs[name],
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "design": DESIGNS[name], "launches_by_path": by_path[name],
                     **({"launch_ms": t["launch_ms"]} if "launch_ms" in t else {})})
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
