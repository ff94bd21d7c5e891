#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Eight serving paths at full width, five hand-written kernels (the four
forwards and the flash attention backward), the perception frame path,
batched multi-camera perception and scenario replay (which run none of
them), chaos at one shard (none either),
multi-tenant decode serving (decode_attention in every shared
step), training (every family: the flash forward and backward
kernels, and the scans' forward kernels with their chunked forms'
gradients) and sharded training (two ranks on the card): qwen3-4b
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
             computes either scan, so their library_ms is null.  Then the
             scans' gradients at the training shapes: the autograd
             backward of the chunked forms (the baseline of a backward
             kernel still to write) against its bound;
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
7b. chaos — chaos at one shard (repro_torch.chaos and the scheduler's
             resilience hooks), which runs none of the kernels: on the card,
             urban_rush_hour replayed plain and with an empty fault plan
             attached (byte-equal), then sensor_stall_storm's fault-free
             base and the storm through the same scheduler, and the storm
             through a CPU scheduler at the same capacity, all with the
             port's seed-7 weights; the two storms' reports must agree as
             phase 7's do and their ledgers event for event; the reference's
             storm gates (fault_inject >= 10, nan_drop, watchdog and retry
             >= 1, every recovery within 20 ticks); one capture per engine
             through all four replays, each tick loop under
             set_sync_debug_mode("error"), the storm's and its base's tick
             wall printed with the card's name and power limit; then
             python -m repro_torch.chaos --episode sensor_stall_storm --check
             on the card, and the one-shard fleet under the storm (at most
             one capture per engine, a non-empty ledger);
7c. fleet  — the multi-shard camera fleet (repro_torch.launch.mesh, the
             sharded executor, the scheduler's placer and rebalance), which
             runs none of the kernels: two shards on the one card
             (make_local_mesh(data=2, devices=[dev, dev]): one CUDA graph
             per shard at batch capacity/2, each replayed on its own
             stream).  shard_loss_rush_hour through a scheduler on the card
             and one on two CPU shards: reports agree as phase 7's do,
             ledgers event for event, the same final occupancy; two
             captures per engine by the warm-up and none added through the
             kill, failover, revive and rebalance (read as the tick loop,
             under set_sync_debug_mode("error"), starts and ends); then
             python -m repro_torch.chaos --episode shard_loss_rush_hour
             --mesh data=2 --mesh-devices cuda:0,cuda:0 --check on the
             card; both goldens on a one-shard mesh byte-equal to their
             meshless replays on the card; and the fleet of FLEET_STREAMS x
             FLEET_TICKS as launch/serve.py --fleet runs it at one and at
             two shards: frames per wall second, tick wall, and the
             device's busy share of a tick (the union of kernel and copy
             intervals over FLEET_PROFILE_TICKS ticks under torch.profiler,
             so two streams' overlap counts once), with the card's name and
             power limit;
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
9. train   — the training paths (repro_torch.train, as launch/train.py
             drives them), TRAIN_PATHS: every family at full width in bf16,
             remat on, TRAIN_STEPS AdamW steps through Trainer.fit:
             qwen3-4b, rwkv6-3b and zamba2-2.7b at full depth on TRAIN_B x
             TRAIN_S tokens, internvl2-1b (text-only loss after the patch
             embeddings) and hubert-xlarge (masked labels) likewise,
             olmoe-1b-7b cut to 8 of 16 layers and mixtral-8x22b to 1 of 56
             layers on 1 x 8192 tokens (the 4096 window in the flash
             backward).  The launch counters are reset just before fit and
             read just after, and held exactly: per step the flash forward
             twice and its backward kernel once per attention site, the
             WKV or SSD forward kernel twice per layer (the scans' gradients
             are their chunked forms' under autograd, which launch
             nothing), nothing else.  The first step's loss against a
             no-grad Model.loss of the same batch, every loss and MoE aux
             finite, the last loss below the first; step mean, CV, p99,
             tokens/s, peak memory, the device's busy share of one step
             (torch.profiler) and, for the scan families, the scans'
             share of it split into the forward kernels and the autograd
             backward; for zamba2-2.7b the bf16 model against its f32 copy
             at the training batch.  Then on smoke models a checkpoint round
             trip on the card, and rwkv6-3b and zamba2-2.7b's loss and every
             gradient leaf on the card against the CPU;
10. sharded — sharded training (Trainer on a TrainMesh,
             distributed/layout.py): a 1 x 1 mesh with FSDP against the
             one-device trainer bit for bit; two ranks spawned on the one
             card over gloo (CUDA tensors), qwen3-4b at full width cut to
             SHARD_LAYERS layers, FSDP at data=2, against one rank of the
             same cut: each rank's parameter and moment bytes exactly half
             (but for the leaves no rule splits), the loss within
             SHARD_BAND, the launches of train_launches on each rank, peak
             memory, step wall and the collectives' share of a step; f32
             smoke qwen3-4b, hubert-xlarge and olmoe-1b-7b at two ranks
             against one; olmoe-1b-7b at full depth over NCCL with two
             cards or more (skipped, with a line that says so, on one);
11. cert    — the static certifier on the card (repro_torch.analysis.cert):
             for each batched rung at one and two shards (cuda:0 twice), a
             real engine whose step is wrapped by a signature recorder runs
             the envelope's occupancy and churn sweep, capturing and
             replaying its step: one capture per shard, no new signature
             after warmup, the signatures the committed
             analysis/torch_certificate.json names; then each (rung, batch
             size) step of an engine at that capacity is measured (device
             time of a whole-capacity submit: upload, replay, readback) and
             printed beside its committed roofline floor; a floor above its
             measurement raises;
12. roofline — qwen3-4b's prefill (4 x 1024), decode step (batch 4,
             context 1024) and train step (2 x 1024) built at those shapes
             on one rank (launch.lowering.build_lowered) and counted
             (launch.roofline.analyze): counted flops, model_flops, the
             compute and memory floors against the device ms (profiler)
             and wall ms that phases 3 and 9 measured, and
             mfu = model_flops / (wall s x 989e12); a floor above the
             device time raises.  The dry-run sweep
             (python -m repro_torch.launch.dryrun --all) takes minutes and
             runs on its own.

The build phase prints each kernel's registers, static shared memory and
spill bytes from the compiler's -Xptxas -v report, and the scan kernels'
blocks per SM from the occupancy API.  Prints the card's name
and power limit, one ``{"kernels": [...]}`` line (each row also names the
kernel's design and splits ``launches`` by path: each arch's prefill and
Engine.generate, the multi-tenant drain, each training path,
"train:<arch>", and the two-rank run, "train_sharded:qwen3-4b", summed
over its ranks), and as the last line ``{"ok": true, "device": {...}}``.
(Phase 4, times, runs last.)
Exits non-zero, with no result, when there is no CUDA device or no
``src/repro_torch`` beside it.
"""
from __future__ import annotations

import argparse
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

# Bounds: each kernel's work from its declared cost (repro_torch.kernels.cost)
# at the H100 SXM's peaks (repro_torch.analysis.cert.roofline.H100_SXM: the
# data sheet's dense rates by unit and the HBM3 rate); the scans multiply in
# split TF32, three tensor-core passes per product (their costs' ``passes``)
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

# the training paths (phase 9): each arch at full width in bf16, remat on,
# TRAIN_STEPS AdamW steps (the CLI's warmup, min(20, steps // 5 + 1)) of
# TRAIN_B x TRAIN_S tokens of make_batch_np, unless its entry cuts the depth
# (layers), sets the batch and sequence, the loss chunk or the learning rate
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 2, 1024, 6, 1e-3
TRAIN_PATHS = {
    "qwen3-4b": {},
    "rwkv6-3b": {},          # the WKV kernel; its gradient the chunked form's
    "zamba2-2.7b": {},       # the SSD kernel, and flash at head_dim 80 at the 9 sites
    "internvl2-1b": {},      # the text-only loss after 256 patch embeddings
    "hubert-xlarge": {},     # the encoder's masked labels, non-causal flash
    # the whole 6.919 B needs about 83 GB of bf16 weights and gradients and
    # f32 moments, more than the card's 80 GB
    "olmoe-1b-7b": dict(layers=8),
    # 2 of 56 layers would need about 65 GB before activations; 1 x 8192
    # engages the 4096 window in the flash backward.  Its 8191 targets are
    # prime, so the chunked loss's divisor rule (the reference's) would take
    # 8191 checkpointed chunks of one target (12 s forward, 22 s backward on
    # the H100): the loss is taken in one chunk (loss_chunk 0).  At TRAIN_LR
    # this one layer of width 6144 diverges from random weights (loss 10.48
    # -> 12.64 in 6 steps, router_z_loss 3.3 -> 186.7), so it takes a tenth
    "mixtral-8x22b": dict(layers=1, batch=1, seq=8192, loss_chunk=0, lr=TRAIN_LR / 10),
}
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
    over the unprofiled wall time of the same work.  Returns, per run, its
    device ms (the summed kernel time of one) and wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (B, S_PREFILL)).astype(np.int32)).to(dev)
    n_steps = 4
    out = {}
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
            out[name] = dict(busy_ms=total_ms, wall_ms=wall_s * 1e3)
            log(f"[profile] {model.cfg.name} {name}: device busy {total_ms:.3f} ms of {wall_s * 1e3:.3f} ms wall "
                f"({total_ms / (wall_s * 1e3):.3f} busy, {1 - total_ms / (wall_s * 1e3):.3f} idle); "
                f"{sum(r[2] for r in rows)} kernels")
            for key, us, count in rows[:8]:
                log(f"[profile]   {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    return out


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


def bound(cost) -> tuple[float, str]:
    """The least ms of a kernel's declared cost on the H100 SXM, and what
    bounds it ("bytes" or "operations")."""
    from repro_torch.analysis.cert.roofline import H100_SXM

    t, by = cost.seconds(H100_SXM)
    return t * 1e3, by


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
    from repro_torch.kernels.cost import flash_attention_cost

    b_ms, b_by = bound(flash_attention_cost(q.shape, k.shape, dt, causal=True))
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
    from repro_torch.kernels.cost import decode_attention_cost

    b_ms, b_by = bound(decode_attention_cost(qd.shape, caches[0][0].shape, dt))
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
    from repro_torch.kernels.cost import flash_attention_bwd_cost
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
    cost = flash_attention_bwd_cost(q.shape, k.shape, dt, causal=True)
    b_ms, b_by = bound(cost)
    log(f"[times] flash_attention_bwd q {tuple(q.shape)} kv {tuple(k.shape)} bf16 causal: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa backward {lib:.4f} ms (|sdpa - kernel| "
        f"{lib_err:.2e}), bound {b_ms:.4f} ms ({b_by}: {cost.flops:.3e} FLOP "
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
    from repro_torch.analysis.cert.roofline import H100_SXM
    from repro_torch.kernels.cost import mamba2_ssd_cost, rwkv6_wkv_cost

    res = {}
    for name, shape in (("rwkv6_wkv", RWKV_FULL), ("mamba2_ssd", MAMBA_FULL)):
        if name == "rwkv6_wkv":
            args = rwkv6_inputs(gen, shape, 0.5, dev)
            call = lambda: K.rwkv6_wkv(*args, RWKV_CHUNK)  # noqa: E731
            plain = lambda: R.rwkv6_wkv_ref(*args)  # noqa: E731
            cost = rwkv6_wkv_cost(args[0].shape)
            what = f"{shape} f32 chunk {RWKV_CHUNK}"
        else:
            n = shape[4]
            args = mamba2_inputs(gen, shape, dev)
            call = lambda: K.mamba2_ssd(*args, MAMBA_CHUNK, MAMBA_HB)  # noqa: E731
            plain = lambda: R.mamba2_ssd_ref(*args)  # noqa: E731
            cost = mamba2_ssd_cost(args[0].shape, n)
            what = f"x {shape[:4]} N {n} f32 chunk {MAMBA_CHUNK} head_block {MAMBA_HB}"
        ks = kernel_rounds(call, 20)
        ms = statistics.median(ks)
        plain_ms = graph_ms(plain, 1, replays=2)
        b_ms, b_by = bound(cost)
        nbytes, flops = cost.bytes, cost.flops
        f32_ms = flops / H100_SXM.peak("f32") * 1e3
        res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)
        log(f"[times] {name} {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
            f"{nbytes / H100_SXM.mem_bw * 1e3:.4f} ms; {flops / 1e9:.2f} GFLOP x {cost.passes} "
            f"split-TF32 passes at 495 TFLOP/s = "
            f"{cost.passes * flops / H100_SXM.peak('tf32') * 1e3:.4f}"
            f" ms; at the f32 CUDA-core rate it would read {f32_ms:.4f} ms); "
            f"{b_ms / ms:.3f} of bound")
        log(f"[times]   {ROUNDS} rounds: kernel {spread(ks)}")
    return res


def scan_grad_work(name: str, shape: tuple, chunk: int):
    """The declared cost of a scan's gradient through its chunked form at
    ``shape`` and ``chunk`` (``kernels.cost.rwkv6_wkv_grad_cost`` /
    ``mamba2_ssd_grad_cost``: each input and the output's gradient read
    once, each input's gradient written once; twice the chunked forward's
    arithmetic, the intra-chunk terms over the triangle the data needs), at
    the f32 CUDA-core rate."""
    from repro_torch.kernels.cost import mamba2_ssd_grad_cost, rwkv6_wkv_grad_cost

    if name == "rwkv6_wkv":
        return rwkv6_wkv_grad_cost(shape, chunk)
    b, s, h, p, n = shape
    return mamba2_ssd_grad_cost((b, s, h, p), n, chunk)


def time_scan_grads(K, gen, dev) -> dict:
    """The scans' gradients at the training paths' shapes (rwkv6-3b: batch
    2 x 1024, 40 heads of 64, the kernel's chunk 32 and the reference's 64
    for the gradient; zamba2-2.7b: 80 heads, P = N = 64, chunk 256): the
    autograd backward of RWKV6WKV / Mamba2SSD (the chunked form recomputed
    and differentiated, the library baseline of a backward kernel still to
    write) against the forward kernel at the same shape, medians of ROUNDS
    rounds between CUDA events, and the backward's bound
    (``scan_grad_work`` at the f32 CUDA-core rate against HBM)."""
    res = {}
    for name, shape in (("rwkv6_wkv", (TRAIN_B, TRAIN_S, 40, 64)),
                        ("mamba2_ssd", (TRAIN_B, TRAIN_S, 80, 64, 64))):
        if name == "rwkv6_wkv":
            ins = rwkv6_inputs(gen, shape, 0.5, dev)
            chunk = RWKV_CHUNK
            call = lambda *a: K.rwkv6_wkv(*a, 32, grad_chunk=chunk)  # noqa: E731
        else:
            ins = mamba2_inputs(gen, shape, dev)
            chunk = MAMBA_CHUNK
            call = lambda *a: K.mamba2_ssd(*a, chunk, MAMBA_HB)  # noqa: E731
        leaves = [x.detach().clone().requires_grad_() for x in ins]
        y = call(*leaves)
        dy = torch.randn(y.shape, generator=gen, device=dev)
        grads = torch.autograd.grad(y, leaves, dy, retain_graph=True)
        if not all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads):
            raise AssertionError(f"{name}: a gradient at the training shape is zero or not finite")
        fwd, bwd = [], []
        for _ in range(ROUNDS):
            with torch.no_grad():
                fwd.append(event_ms(lambda: call(*ins), 5))
            bwd.append(event_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True), 3))
        cost = scan_grad_work(name, shape, chunk)
        nbytes, flops = cost.bytes, cost.flops
        b_ms, b_by = bound(cost)
        ms, f_ms = statistics.median(bwd), statistics.median(fwd)
        res[name] = dict(library_ms=ms, fwd_ms=f_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"[times] {name} gradient {shape} f32, chunk {chunk}: autograd backward (the "
            f"chunked form recomputed and differentiated; the baseline of a backward kernel) "
            f"{ms:.4f} ms, {ms / f_ms:.1f} x the forward kernel's {f_ms:.4f} ms at this shape; "
            f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at "
            f"67 TFLOP/s f32); {b_ms / ms:.3f} of bound")
        log(f"[times]   {ROUNDS} rounds: backward {spread(bwd)}; forward kernel {spread(fwd)}")
        del y, dy, grads, leaves, ins
        torch.cuda.empty_cache()
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
    time_scan_grads(K, gen, dev)
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
        doc = serve_fleet(_fleet_args(dev, 1))
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


# ---- phase 7b: chaos at one shard (repro_torch.chaos)
CHAOS_EPISODE = "sensor_stall_storm"
# the reference's storm gates (tests/test_chaos.py:317-336)
CHAOS_GATES = {"fault_inject": 10, "nan_drop": 1, "watchdog": 1, "retry": 1}
CHAOS_RECOVERY_BOUND = 20


def phase_chaos(dev, smi: str):
    """The storm on the card against the CPU, its gates, one capture per
    engine through it, an empty plan inert, the chaos CLI's gates and a
    one-shard fleet under the storm (module docstring, phase 7b)."""
    from repro_torch import kernels as K
    from repro_torch.batched import RungBucketScheduler
    from repro_torch.chaos import FaultPlan, get_chaos_episode, run_chaos_episode
    from repro_torch.chaos.__main__ import main as chaos_main
    from repro_torch.launch.serve import serve_fleet
    from repro_torch.scenarios import ScenarioReplayer, Tolerance, compare_reports, \
        compile_trace, get_episode, golden_replay, replay_ladder
    from repro_torch.scenarios.golden import GOLDEN_CAPACITY, GOLDEN_EPISODES, \
        GOLDEN_TICK_SCALE

    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True        # torch's default, as phases 5 to 7
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        # ---- an empty plan attached is pure observation, on the card
        name = "urban_rush_hour"
        plain, sched = golden_replay(name, sentinel=TickLoopGuard(), device=str(dev))
        trace = compile_trace(get_episode(name), seed=GOLDEN_EPISODES[name],
                              tick_scale=GOLDEN_TICK_SCALE)
        empty = ScenarioReplayer(trace, scheduler=sched, chaos=FaultPlan.empty()).run(
            sentinel=TickLoopGuard())
        if empty.chaos is not None or empty.to_json(indent=2) != plain.to_json(indent=2):
            raise AssertionError(f"chaos: {name} with an empty plan differs from its plain "
                                 f"replay on the card")

        # ---- the storm's fault-free base, then the storm, on the card and the CPU
        ep = get_chaos_episode(CHAOS_EPISODE)
        base = compile_trace(get_episode(ep.base), seed=ep.seed, tick_scale=ep.tick_scale)
        base_guard = TickLoopGuard()
        ScenarioReplayer(base, scheduler=sched).run(sentinel=base_guard)
        storms, guard = {}, TickLoopGuard()
        cpu_sched = RungBucketScheduler(replay_ladder(), capacity=GOLDEN_CAPACITY, device="cpu")
        for where, sch, g in (("card", sched, guard), ("cpu", cpu_sched, None)):
            report, replayer, plan = run_chaos_episode(CHAOS_EPISODE, scheduler=sch, sentinel=g)
            storms[where] = (report, replayer.injector.ledger)
        (card, card_ledger), (cpu, cpu_ledger) = storms["card"], storms["cpu"]
        problems = compare_reports(card.to_dict(), cpu.to_dict(), Tolerance(**REPLAY_TOL))
        if problems:
            raise AssertionError(f"chaos: the card's storm differs from the CPU's: "
                                 + "; ".join(problems[:5]))
        a, b = [e.to_dict() for e in card_ledger.events], [e.to_dict() for e in cpu_ledger.events]
        if a != b:
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            raise AssertionError(f"chaos: ledgers differ from event {i}: card {a[i:i + 1]}, "
                                 f"cpu {b[i:i + 1]}")
        counts = card_ledger.counts()
        short = {k: counts.get(k, 0) for k, n in CHAOS_GATES.items() if counts.get(k, 0) < n}
        recovery = card_ledger.recovery_times()
        if short or not recovery or max(recovery) > CHAOS_RECOVERY_BOUND:
            raise AssertionError(f"chaos: storm gates failed: counts {counts} (need "
                                 f"{CHAOS_GATES}), recoveries {recovery}")
        caps = {n: e.executor.step_captures for n, e in sched.engines.items()}
        if any(c != 1 for c in caps.values()):
            raise AssertionError(f"chaos: an engine captured its step again: {caps}")
        ms_tick = guard.seconds / card.n_ticks * 1e3
        base_ms = base_guard.seconds / base.n_ticks * 1e3
        log(f"[chaos] {CHAOS_EPISODE}: card equals CPU ({len(card_ledger)} ledger events, "
            f"counts {counts}, recoveries {recovery} ticks, {card.totals()['frames']} frames, "
            f"clock {card.clock_s:.6f} s virtual); an empty plan on {name} byte-equal to its "
            f"plain replay; step_captures per engine through golden, empty plan, base and "
            f"storm {caps}")
        log(f"[chaos] tick loop under set_sync_debug_mode('error'), {smi}: storm "
            f"{guard.seconds:.3f} s wall for {card.n_ticks} ticks ({ms_tick:.3f} ms a tick); "
            f"its fault-free base {ep.base} (seed {ep.seed}) {base_guard.seconds:.3f} s for "
            f"{base.n_ticks} ticks ({base_ms:.3f} ms a tick)")

        # ---- the chaos CLI's gates on the card (its own scheduler, capacity 3)
        if chaos_main(["--episode", CHAOS_EPISODE, "--check", "--device", str(dev)]) != 0:
            raise AssertionError("chaos: python -m repro_torch.chaos --check failed on the card")

        # ---- a one-shard fleet under the storm, as launch/serve.py --fleet --chaos runs it
        doc = serve_fleet(_fleet_args(dev, 1, chaos=CHAOS_EPISODE))
        if not doc.get("chaos", {}).get("events") or any(
                c > 1 for c in doc["trace_counts"].values()):
            raise AssertionError(f"chaos fleet: ledger {doc.get('chaos')}, captures "
                                 f"{doc['trace_counts']}")
        log(f"[chaos] fleet {FLEET_STREAMS} x {FLEET_TICKS} under {CHAOS_EPISODE}: ledger "
            f"{doc['chaos']['counts']}, captures {doc['trace_counts']}, {doc['frames']} "
            f"frames, {doc['wall_s']:.3f} s wall")
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
        torch.cuda.set_sync_debug_mode("default")
    counts = K.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"chaos: the chaos path launched kernels {counts}")
    log(f"[chaos] kernel launch counters over the phase: {counts}; phase "
        f"{time.perf_counter() - t0:.1f}s")


# ---- phase 7c: the multi-shard camera fleet (two shards on one card)
FLEET_SHARDS = 2
FLEET_PROFILE_TICKS = 10


def _fleet_args(dev, shards: int, chaos=None) -> argparse.Namespace:
    """launch/serve.py --fleet's arguments, at ``shards`` shards on ``dev``."""
    mesh = dict(mesh=None, mesh_devices=None) if shards == 1 else dict(
        mesh=f"data={shards}", mesh_devices=",".join([str(dev)] * shards))
    return argparse.Namespace(batch=4, streams=FLEET_STREAMS, ticks=FLEET_TICKS, obs=False,
                              slo_ms=None, json_out=None, trace_out=None, device=str(dev),
                              chaos=chaos, **mesh)


def _busy_share(dev, shards: int) -> tuple[float, float]:
    """(device busy share, host wall ms) of a fleet tick at ``shards``
    shards: FLEET_STREAMS streams as serve_fleet seats them, warmed over
    FLEET_TICKS // 4 ticks, then FLEET_PROFILE_TICKS ticks under the
    profiler; busy is the union of the device's kernel and copy intervals
    (two streams' overlap counted once) over the window's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.batched import RungBucketScheduler
    from repro_torch.bus import SimClock
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.perception import SceneConfig, generate_scene
    from repro_torch.scenarios import ModeledStageCost, replay_ladder

    ladder = replay_ladder()
    sched = RungBucketScheduler(ladder, capacity=max(4, FLEET_STREAMS), clock=SimClock(),
                                stage_cost=ModeledStageCost(ladder, seed=0), device=dev,
                                mesh=make_local_mesh(data=shards, devices=[dev] * shards))
    sched.warm(SceneConfig(scenario="city", seed=7))
    sids = [f"cam{i:02d}" for i in range(FLEET_STREAMS)]
    for sid in sids:
        sched.add_stream(sid, 0.03)
    scenes = [{sid: generate_scene(SceneConfig(scenario="city", seed=i), t)
               for i, sid in enumerate(sids)} for t in range(FLEET_TICKS)]
    for t in range(FLEET_TICKS // 4):
        sched.tick(scenes[t])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(FLEET_PROFILE_TICKS):
            sched.tick(scenes[FLEET_TICKS // 4 + t])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / wall_us, wall_us / 1e3 / FLEET_PROFILE_TICKS


def phase_fleet(dev, smi: str):
    """shard_loss_rush_hour at two shards on the card against two CPU
    shards, its CLI gates, the one-shard mesh replays byte-equal to the
    meshless ones, and the fleet at one and two shards (module docstring,
    phase 7c)."""
    from repro_torch import kernels as K
    from repro_torch.batched import RungBucketScheduler
    from repro_torch.chaos import CHAOS_CATALOG, run_chaos_episode
    from repro_torch.chaos.__main__ import main as chaos_main
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import serve_fleet
    from repro_torch.scenarios import ScenarioReplayer, Tolerance, compare_reports, \
        compile_trace, get_episode, golden_replay, replay_ladder
    from repro_torch.scenarios.golden import GOLDEN_CAPACITY, GOLDEN_EPISODES, \
        GOLDEN_TICK_SCALE

    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True        # torch's default, as phases 5 to 7b
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        # ---- shard_loss_rush_hour at two shards: the card against two CPU shards
        name = "shard_loss_rush_hour"
        cap = CHAOS_CATALOG[name].capacity
        runs, at = {}, []

        class Captures(TickLoopGuard):
            """The tick loop's guard, reading each engine's captures as it
            starts and as it ends."""

            def __init__(self, sched):
                super().__init__()
                self.sched = sched

            def read(self):
                at.append([e.executor.step_captures for e in self.sched.engines.values()])

            def __enter__(self):
                self.read()
                return super().__enter__()

            def __exit__(self, *exc):
                out = super().__exit__(*exc)
                self.read()
                return out

        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            sched = RungBucketScheduler(
                replay_ladder(), capacity=cap, device=d,
                mesh=make_local_mesh(data=FLEET_SHARDS, devices=[d] * FLEET_SHARDS))
            guard = Captures(sched) if where == "card" else None
            report, replayer, _ = run_chaos_episode(name, scheduler=sched, sentinel=guard)
            runs[where] = (report, replayer, guard)
        (card, card_rep, guard), (cpu, cpu_rep, _) = runs["card"], runs["cpu"]
        problems = compare_reports(card.to_dict(), cpu.to_dict(), Tolerance(**REPLAY_TOL))
        if problems:
            raise AssertionError(f"fleet: the card's {name} differs from the CPU's: "
                                 + "; ".join(problems[:5]))
        card_ledger, cpu_ledger = card_rep.injector.ledger, cpu_rep.injector.ledger
        a = [e.to_dict() for e in card_ledger.events]
        b = [e.to_dict() for e in cpu_ledger.events]
        if a != b:
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            raise AssertionError(f"fleet: ledgers differ from event {i}: card {a[i:i + 1]}, "
                                 f"cpu {b[i:i + 1]}")
        occ = {n: e.shard_occupancy() for n, e in card_rep.scheduler.engines.items()}
        if occ != {n: e.shard_occupancy() for n, e in cpu_rep.scheduler.engines.items()}:
            raise AssertionError(f"fleet: final occupancy on the card {occ} differs from the CPU's")
        counts, reseat = card_ledger.counts(), card_ledger.reseat_ticks()
        if not counts.get("failover") or reseat is None or reseat > 3:
            raise AssertionError(f"fleet: {name} gates failed: counts {counts}, reseat {reseat}")
        want = [[FLEET_SHARDS] * len(occ)] * 2
        if at != want:
            raise AssertionError(f"fleet: captures per engine at the tick loop's start and end "
                                 f"{at}, not {want}")
        log(f"[fleet] {name} at {FLEET_SHARDS} shards on one card equals two CPU shards "
            f"({len(card_ledger)} ledger events, counts {counts}, worst reseat {reseat} ticks, "
            f"{card.totals()['frames']} frames, clock {card.clock_s:.6f} s virtual, final "
            f"occupancy {occ}); step_captures per engine {at[0]} at the tick loop's start and "
            f"{at[1]} at its end; tick loop under set_sync_debug_mode('error'), {smi}: "
            f"{guard.seconds:.3f} s wall for {card.n_ticks} ticks "
            f"({guard.seconds / card.n_ticks * 1e3:.3f} ms a tick)")

        # ---- the chaos CLI's gates at two shards on the card
        if chaos_main(["--episode", name, "--mesh", f"data={FLEET_SHARDS}", "--mesh-devices",
                       ",".join([str(dev)] * FLEET_SHARDS), "--check",
                       "--device", str(dev)]) != 0:
            raise AssertionError(f"fleet: python -m repro_torch.chaos --episode {name} --mesh "
                                 f"--check failed on the card")

        # ---- a one-shard mesh replays byte-equal to no mesh, on the card
        sched = None
        for episode in GOLDEN_EPISODES:
            plain, sched = golden_replay(episode, scheduler=sched,
                                         device=None if sched else str(dev))
            trace = compile_trace(get_episode(episode), seed=GOLDEN_EPISODES[episode],
                                  tick_scale=GOLDEN_TICK_SCALE)
            one = ScenarioReplayer(trace, capacity=GOLDEN_CAPACITY, device=str(dev),
                                   mesh=make_local_mesh(data=1, devices=[dev])).run(
                sentinel=TickLoopGuard())
            if one.to_json(indent=2) != plain.to_json(indent=2):
                raise AssertionError(f"fleet: {episode} on a one-shard mesh differs from its "
                                     f"meshless replay on the card")
        log(f"[fleet] {', '.join(GOLDEN_EPISODES)} on a one-shard mesh byte-equal to their "
            f"meshless replays on the card")

        # ---- the fleet at one and two shards, as launch/serve.py --fleet runs it
        for shards in (1, FLEET_SHARDS):
            doc = serve_fleet(_fleet_args(dev, shards))
            if (doc["n_shards"], doc["frames"]) != (shards, FLEET_STREAMS * FLEET_TICKS) or any(
                    c != shards for c in doc["trace_counts"].values()):
                raise AssertionError(f"fleet: {shards} shard(s): {doc['n_shards']} shards, "
                                     f"{doc['frames']} frames, captures {doc['trace_counts']}")
            busy, tick_ms = _busy_share(dev, shards)
            log(f"[fleet] {FLEET_STREAMS} streams x {FLEET_TICKS} ticks at {shards} shard(s), "
                f"{smi}: {doc['frames'] / doc['wall_s']:.1f} frames per wall second, tick wall "
                f"{doc['wall_s'] / FLEET_TICKS * 1e3:.3f} ms ({doc['wall_s']:.3f} s), "
                f"{doc['frames_per_vs']:.3f} frames per virtual second; occupancy "
                f"{doc['shard_occupancy']}; profiled window of {FLEET_PROFILE_TICKS} ticks on "
                f"scenes made beforehand: {tick_ms:.3f} ms a tick, device busy {busy:.3f} of it")
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
        torch.cuda.set_sync_debug_mode("default")
    counts = K.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"fleet: the fleet path launched kernels {counts}")
    log(f"[fleet] kernel launch counters over the phase: {counts}; phase "
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


# the scans' forward kernels (by the names in their sources) and their
# autograd Functions' backward nodes, for the split of a train step's
# device time
SCAN_FWD_KERNELS = {"rwkv6_wkv": ("wkv_scores_kernel", "wkv_fwd_kernel"),
                    "mamba2_ssd": ("ssd_scores_kernel", "ssd_fwd_kernel")}
SCAN_BWD_NODES = {"rwkv6_wkv": "RWKV6WKVBackward", "mamba2_ssd": "Mamba2SSDBackward"}


def _device_total_us(evt) -> float:
    """A CPU op's device time with its children's (the kernels launched
    inside it); the attribute's name changed across torch versions."""
    return getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)


def _train_step_busy(model, params, opt_state, batch, opt_cfg, wall_s: float, tag: str) -> dict:
    """The device's busy share of one train step: its kernels' summed
    device time (torch.profiler) over the unprofiled step's wall time; for
    the scan families the scans' share of it, split into the forward
    kernels (launched in the forward and in remat's recomputation) and the
    autograd backward (the Function's backward node: the chunked form
    recomputed and differentiated)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import make_train_step

    step = make_train_step(model, opt_cfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    rows = [(e.key, _device_us(e), e.count) for e in events
            if e.device_type != DeviceType.CPU and _device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    log(f"[train] {tag} one step under the profiler: device busy {busy_ms:.3f} ms of "
        f"{wall_s * 1e3:.3f} ms wall ({busy_ms / (wall_s * 1e3):.3f} busy, "
        f"{1 - busy_ms / (wall_s * 1e3):.3f} idle); {sum(r[2] for r in rows)} kernels")
    for key, us, count in rows[:10]:
        log(f"[train]   {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    out = dict(busy=busy_ms / (wall_s * 1e3), busy_ms=busy_ms)
    for name, kernels in SCAN_FWD_KERNELS.items():
        fwd = [(us, c) for key, us, c in rows if any(k in key for k in kernels)]
        if not fwd:
            continue
        fwd_ms = sum(us for us, _ in fwd) / 1e3
        bwd = [e for e in events if e.key == SCAN_BWD_NODES[name]]
        bwd_ms = sum(_device_total_us(e) for e in bwd) / 1e3
        out[name] = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms)
        log(f"[train] {tag} {name} in the step: forward kernels {fwd_ms:.3f} ms "
            f"({fwd_ms / busy_ms:.3f} of device time, {sum(c for _, c in fwd)} launches of "
            f"{len(kernels)} kernels); autograd backward "
            + (f"{bwd_ms:.3f} ms ({bwd_ms / busy_ms:.3f}, {sum(e.count for e in bwd)} calls of "
               f"{SCAN_BWD_NODES[name]})" if bwd_ms > 0 else
               f"not measured (the profiler linked no device time to {SCAN_BWD_NODES[name]})"))
    return out


def train_launches(model) -> dict:
    """The kernels' launches in one train step: per attention site the flash
    forward (twice with remat: the forward and the recomputation) and its
    backward kernel once; per RWKV6 or Mamba2 layer its scan's forward
    kernel (twice with remat), whose gradient is the chunked form's under
    autograd and launches nothing; no decode."""
    cfg = model.cfg
    fwd = 2 if cfg.remat else 1
    sites = model.n_attn_sites()
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_attention=fwd * sites, flash_attention_bwd=sites)
    if cfg.family == "ssm":
        want["rwkv6_wkv"] = fwd * cfg.num_layers
    if cfg.family == "hybrid":
        want["mamba2_ssd"] = fwd * cfg.num_layers
    return want


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _bf16_against_f32(model, params, batch) -> None:
    """zamba2-2.7b's bf16 margin at the training batch: the no-grad loss and
    the last position's logits (Model.prefill) of the bf16 model against
    the same weights upcast to f32 (the scans are f32 in both; flash runs
    its f32 kernel), the logits' largest difference over the largest f32
    logit.  Printed, not held: the serving paths' prefill-against-decode
    check holds the 5e-2 limit."""
    from repro_torch.models import Model

    m32 = Model(model.cfg.replace(dtype="float32", param_dtype="float32"))
    p32 = _tree_map(lambda t: t.detach().float(), params)
    with torch.no_grad():
        loss16, loss32 = model.loss(params, batch)[0].item(), m32.loss(p32, batch)[0].item()
        l16, l32 = model.prefill(params, batch).float(), m32.prefill(p32, batch)
    rel = ((l16 - l32).abs().max() / l32.abs().max()).item()
    log(f"[train] {model.cfg.name} bf16 against f32 weights at the training batch: loss "
        f"{loss16:.6f} vs {loss32:.6f} ({abs(loss16 - loss32) / abs(loss32):.3e} relative); last "
        f"position's logits differ by {rel:.3e} of the largest f32 logit (serving's "
        f"prefill-against-decode limit 5e-2)")


def train_path(dev, smi: str, arch: str, cut: dict) -> dict:
    """One training path (repro_torch.train, as launch/train.py drives
    it): ``arch`` at full width in bf16 (depth, batch and sequence as
    ``cut`` says), Trainer.init and Trainer.fit over synthetic_batches
    through a PrefetchIterator, remat on, the kernels' launch counters reset
    just before fit and read just after and held to TRAIN_STEPS x
    ``train_launches``.  Checks: the first step's loss against a no-grad
    Model.loss of the same batch (bf16 band: 4e-3 relative), every loss
    and MoE aux finite and the last loss below the first.  Prints the
    step time (mean, CV, p99), tokens/s, peak memory, the device's busy
    share of a step and, for the scan families, the scans' share of it."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import (AdamWConfig, DataConfig, PrefetchIterator, TrainConfig,
                                   Trainer, make_batch_np, synthetic_batches)
    from repro_torch.train.data import to_device

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch)
    cfg = full.replace(num_layers=cut.get("layers", full.num_layers),
                       loss_chunk=cut.get("loss_chunk", full.loss_chunk))
    model = Model(cfg)
    b, s = cut.get("batch", TRAIN_B), cut.get("seq", TRAIN_S)
    what = (f"depth cut to {cfg.num_layers} of {full.num_layers} layers" if "layers" in cut
            else "full width and depth")
    opt = AdamWConfig(lr=cut.get("lr", TRAIN_LR), warmup_steps=min(20, TRAIN_STEPS // 5 + 1),
                      total_steps=TRAIN_STEPS)
    trainer = Trainer(model, dev, TrainConfig(opt=opt, log_every=1))
    params, opt_state = trainer.init(0)
    torch.cuda.synchronize()
    tag = f"[{arch}]"
    log(f"[train] {tag} {what} ({cfg.num_layers} layers, remat {cfg.remat}, loss_chunk "
        f"{cfg.loss_chunk}), batch {b} x {s}, lr {opt.lr:g}, bf16 weights and f32 AdamW moments: "
        f"{model.num_params() / 1e9:.3f}B params (full depth "
        f"{Model(full).num_params() / 1e9:.3f}B); {torch.cuda.memory_allocated() / 1e9:.1f} GB "
        f"allocated after init "
        f"({time.perf_counter() - t0:.1f}s)")
    data = DataConfig(batch=b, seq_len=s)
    batch0 = to_device(make_batch_np(cfg, data, 0), dev)
    with torch.no_grad():
        ref_loss = model.loss(params, batch0)[0].item()
    if arch == "zamba2-2.7b":
        _bf16_against_f32(model, params, batch0)
    del batch0

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
    per_step = train_launches(model)
    want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"train {arch}: launches {counts}, expected {want}")
    loss = [m["loss"] for m in losses]
    for i, m in enumerate(losses):
        aux = "".join(f" {k}={m[k]:.4f}" for k in ("load_balance_loss", "router_z_loss",
                                                    "drop_fraction") if k in m)
        log(f"[train] {tag} step {i} loss={m['loss']:.6f} ce={m['ce']:.6f} lr={m['lr']:.3e} "
            f"gnorm={m['grad_norm']:.4f}{aux}")
    if not all(math.isfinite(v) for m in losses for v in m.values()) or not loss[-1] < loss[0]:
        raise AssertionError(f"train {arch}: losses {loss} (or metrics) not finite or not "
                             f"decreasing")
    if not abs(loss[0] - ref_loss) <= 4e-3 * abs(ref_loss):
        raise AssertionError(f"train {arch}: first step's loss {loss[0]} vs no-grad Model.loss "
                             f"{ref_loss}")
    st = trainer.latency_summary()
    toks = b * s
    log(f"[train] {tag} launches on the main path over {TRAIN_STEPS} steps: "
        f"{ {k: v for k, v in counts.items() if v} } (a step: "
        f"{ {k: v for k, v in per_step.items() if v} })")
    log(f"[train] {tag} first step's loss {loss[0]:.6f} vs no-grad Model.loss of the same batch "
        f"{ref_loss:.6f} (|diff| {abs(loss[0] - ref_loss):.2e}; band 4e-3 relative)")
    log(f"[train] {tag} train_step ({b} x {s} tokens, {st.n} steps after the first): mean "
        f"{st.mean * 1e3:.3f} ms cv {st.cv:.4f} p99 {st.p99 * 1e3:.3f} ms -> "
        f"{toks / st.mean:.1f} tokens/s; fit {fit_s:.3f}s; peak memory {peak / 1e9:.3f} GB "
        f"(torch.cuda.max_memory_allocated); card {smi}")
    batch = to_device(make_batch_np(cfg, data, TRAIN_STEPS), dev)
    prof = _train_step_busy(model, params, opt_state, batch, opt, st.mean, tag)
    del params, opt_state, trainer, batch, batches
    torch.cuda.empty_cache()
    log(f"[train] {tag} {time.perf_counter() - t0:.1f}s")
    return dict(counts=counts, peak_gb=peak / 1e9, step_ms=st.mean * 1e3, **prof)


def phase_train(dev, smi: str) -> dict:
    """The training paths of TRAIN_PATHS (``train_path`` each), then on
    smoke models: a checkpoint round trip on the card (a trained state
    saved, loaded, equal bit for bit), and rwkv6-3b and zamba2-2.7b under
    grad on the card against the CPU (launches held exactly, the loss
    within 1e-5 relative, every gradient leaf nonzero and within 1e-3 of its
    largest element: the scans' forward kernels against the step
    recurrences, and the chunked forms' gradients on both devices).
    Returns each path's launch counts and measurements."""
    import tempfile

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig, Trainer,
                                   load_checkpoint, make_batch_np, save_checkpoint,
                                   synthetic_batches)
    from repro_torch.train.optimizer import _walk

    t0 = time.perf_counter()
    res = {arch: train_path(dev, smi, arch, cut) for arch, cut in TRAIN_PATHS.items()}

    # ---- smoke: a checkpoint round trip on the card
    small = Model(get_config("qwen3-4b", smoke=True))
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

    # ---- smoke: the scan families' gradients on the card against the CPU
    for arch in ("rwkv6-3b", "zamba2-2.7b"):
        m = Model(get_config(arch, smoke=True))
        p_cpu = m.init(1, device="cpu")
        batch = make_batch_np(m.cfg, DataConfig(2, 64), 0)
        out = {}
        for where, params in (("cpu", p_cpu), ("card", to_device(p_cpu, dev))):
            leaves = [p.requires_grad_() for _, p in _walk(params)]
            K.reset_launch_counts()
            loss, _ = m.loss(params, {k: torch.from_numpy(v).to(leaves[0].device)
                                      for k, v in batch.items()})
            grads = torch.autograd.grad(loss, leaves)
            out[where] = (loss.item(), [g.cpu() for g in grads], K.launch_counts())
        if out["card"][2] != train_launches(m) or any(out["cpu"][2].values()):
            raise AssertionError(f"train: {arch} smoke launches {out['card'][2]} on the card, "
                                 f"{out['cpu'][2]} on the CPU; expected {train_launches(m)}")
        if not abs(out["card"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0]):
            raise AssertionError(f"train: {arch} smoke loss {out['card'][0]} on the card vs "
                                 f"{out['cpu'][0]} on the CPU")
        worst = 0.0
        for g, w in zip(out["card"][1], out["cpu"][1]):
            scale = max(w.abs().max().item(), 1e-30)
            err = (g - w).abs().max().item()
            if not g.abs().max() > 0 or not err <= 1e-3 * scale:
                raise AssertionError(f"train: {arch} smoke gradients on the card differ from "
                                     f"the CPU's: {err:.3e} of {scale:.3e}")
            worst = max(worst, err / scale)
        log(f"[train] {arch} smoke (f32) under grad on the card: launches "
            f"{ {k: v for k, v in out['card'][2].items() if v} }; loss {out['card'][0]:.6f} vs "
            f"CPU {out['cpu'][0]:.6f}; {len(out['cpu'][1])} gradient leaves, all nonzero, within "
            f"{worst:.2e} of each leaf's largest element (band 1e-3)")
    torch.cuda.empty_cache()
    log(f"[train] phase {time.perf_counter() - t0:.1f}s")
    return res


# sharded training (phase 10).  Two ranks share the one card over gloo
# (NCCL refuses two ranks of one communicator on one GPU); SHARD_LAYERS of
# qwen3-4b's 36 layers at full width (bf16 weights, f32 moments), FSDP at
# data=2, SHARD_STEPS steps of SHARD_B x SHARD_S, against one rank of the
# same cut.  SHARD_BAND: each step's loss against the one rank's, relative
# (step 0, later steps).  Step 0 comes before any update, so only the
# forward over each rank's rows shows there; after it bf16 GEMMs over one
# rank's rows round otherwise than over both ranks' rows, and the bf16
# weights move apart by a rounding here and there.  Each limit sits between
# the sound run's readings (7.985e-8; 9.212e-4 and 1.338e-3) and those of a
# control whose ranks skip the reduction (1.397e-2 and 2.494e-2 after step
# 0): tools/shard_band_controls.py on an H100 80GB HBM3 at 700 W.  At two
# ranks a reduction in bf16 gives the f32 one's losses bit for bit (a sum
# of two rounds once either way), so no band sees it there; the CPU tests
# hold the f32 reduction over four ranks.  The f32 smoke runs take the CPU
# tests' optimizer (tests/test_torch_sharded_train.py): at the default
# eps = 1e-8 AdamW turns last-bit differences of gradient elements near eps
# into a good part of lr.
SHARD_LAYERS = 8
SHARD_B, SHARD_S, SHARD_STEPS = 2, 1024, 3
SHARD_BAND = (1e-6, 4e-3)
SHARD_SMOKE = ("qwen3-4b", "hubert-xlarge", "olmoe-1b-7b")
SHARD_SMOKE_STEPS = 2
SHARD_OPT32 = dict(lr=1e-4, eps=1e-6, warmup_steps=1, total_steps=8)
SHARD_TOL32 = dict(loss=1e-5, leaf=1e-4)


def _resident(*trees) -> int:
    """Bytes of the tensors of nested dicts (blocks, moments)."""
    from repro_torch.train.optimizer import _walk
    return sum(t.numel() * t.element_size() for tree in trees for _, t in _walk(tree))


def _np_tree(tree) -> dict:
    from repro_torch.train.optimizer import _walk
    return {"/".join(k): v.detach().float().cpu().numpy() for k, v in _walk(tree)}


def _shard_width(rank: int, job: dict, device: str) -> dict:
    """One rank of the full-width two-rank run: init, the launch counters
    around fit, resident bytes, peak memory, step wall, and one more step
    under the profiler for the collectives' share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as K
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models import Model
    from repro_torch.train import DataConfig, TrainConfig, Trainer, make_batch_np, synthetic_batches

    dev = torch.device(device)
    cfg = job["cfg"]
    model = Model(cfg)
    mesh = make_train_mesh(data=job["data"], device=dev)
    tr = Trainer(model, mesh, TrainConfig(opt=job["opt"], log_every=1), fsdp=True)
    t0 = time.perf_counter()
    params, state = tr.init(0)
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    data = DataConfig(job["batch"], job["seq"])
    metrics = []
    K.reset_launch_counts()
    params, state = tr.fit(params, state, synthetic_batches(cfg, data), job["steps"],
                           log=lambda i, m: metrics.append(m))
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    st = tr.latency_summary()
    batch = make_batch_np(cfg, data, job["steps"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        params, state = tr.fit(params, state, iter([batch]), 1)
        wall_ms = (time.perf_counter() - t1) * 1e3
    from torch.autograd import DeviceType
    coll, busy_us, copy_us, nccl_us = {}, 0.0, 0.0, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key.startswith("collective:"):
            coll[e.key] = (e.cpu_time_total / 1e3, e.count)
        elif e.device_type != DeviceType.CPU:
            busy_us += _device_us(e)
            copy_us += _device_us(e) if "memcpy" in e.key.lower() else 0.0
            nccl_us += _device_us(e) if "nccl" in e.key.lower() else 0.0
    return dict(busy_ms=busy_us / 1e3, copy_ms=copy_us / 1e3, nccl_ms=nccl_us / 1e3,
                metrics=metrics, counts=counts, peak=peak, step_ms=st.mean * 1e3,
                step_cv=st.cv, init_s=init_s, resident=_resident(params, state.mu, state.nu),
                prof_wall_ms=wall_ms, collectives=coll)


def _shard_smoke(rank: int, job: dict, device: str) -> dict:
    """One rank of an f32 smoke run: metrics and (rank 0) the gathered
    final parameters."""
    from repro_torch import kernels as K
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models import Model
    from repro_torch.train import DataConfig, TrainConfig, Trainer, synthetic_batches

    model = Model(job["cfg"])
    mesh = make_train_mesh(data=job["data"], device=torch.device(device))
    tr = Trainer(model, mesh, TrainConfig(opt=job["opt"], log_every=1), fsdp=True)
    params, state = tr.init(0)
    metrics = []
    K.reset_launch_counts()
    params, state = tr.fit(params, state, synthetic_batches(model.cfg, DataConfig(
        job["batch"], job["seq"])), job["steps"], log=lambda i, m: metrics.append(m))
    counts = K.launch_counts()
    full = _np_tree(tr.full_params(params))
    return dict(metrics=metrics, counts=counts, full=full if rank == 0 else None)


def _sharded_ranks(rank: int, jobs: list, devices: list) -> list:
    """A spawned rank of phase 10 on the card ``devices[rank]``: each job
    in turn (children run this module as ``__mp_main__``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(torch.device(devices[rank]))
    kinds = {"width": _shard_width, "smoke": _shard_smoke}
    return [kinds[job["kind"]](rank, job, devices[rank]) for job in jobs]


def one_rank_width(dev):
    """One rank of phase 10's full-width cut on the card: the model, the
    optimizer config, every step's metrics, the bytes of parameters and
    moments, the launch counts, the step summary and the peak memory."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig, DataConfig, TrainConfig, Trainer, synthetic_batches

    model = Model(get_config("qwen3-4b").replace(num_layers=SHARD_LAYERS))
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=min(20, SHARD_STEPS // 5 + 1),
                      total_steps=SHARD_STEPS)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(model, dev, TrainConfig(opt=opt, log_every=1))
    p, st = tr.init(0)
    one_bytes = _resident(p, st.mu, st.nu)
    one = []
    K.reset_launch_counts()
    p, st = tr.fit(p, st, synthetic_batches(model.cfg, DataConfig(SHARD_B, SHARD_S)),
                   SHARD_STEPS, log=lambda i, m: one.append(m))
    counts = K.launch_counts()
    step = tr.latency_summary()
    peak = torch.cuda.max_memory_allocated()
    del p, st, tr
    torch.cuda.empty_cache()
    return model, opt, one, one_bytes, counts, step, peak


def band_readings(metrics: list, one: list) -> list:
    """Each step's loss against the one rank's, relative."""
    return [abs(m["loss"] - m1["loss"]) / abs(m1["loss"]) for m, m1 in zip(metrics, one)]


def _one_rank_smoke(dev, arch: str, steps: int, batch: int, seq: int):
    """The one-device Trainer on an f32 smoke model: metrics and final
    parameters."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig, DataConfig, TrainConfig, Trainer, synthetic_batches

    model = Model(get_config(arch, smoke=True))
    tr = Trainer(model, dev, TrainConfig(opt=AdamWConfig(**SHARD_OPT32), log_every=1))
    params, state = tr.init(0)
    metrics = []
    params, state = tr.fit(params, state, synthetic_batches(model.cfg, DataConfig(batch, seq)),
                           steps, log=lambda i, m: metrics.append(m))
    return metrics, _np_tree(params)


def phase_sharded_train(dev, smi: str) -> dict:
    """Sharded training (repro_torch.train.Trainer on a TrainMesh):

    1. a world of one — a 1 x 1 training mesh with FSDP against the
       one-device Trainer on the card, qwen3-4b smoke f32, 3 steps: every
       step's metrics and every final leaf equal bit for bit;
    2. two ranks on the card (spawned, gloo with CUDA tensors): qwen3-4b at
       full width cut to SHARD_LAYERS layers, FSDP at data=2, global batch
       SHARD_B x SHARD_S, SHARD_STEPS steps, seed 0, against one rank of
       the same cut: each rank's resident bytes of parameter and moment
       blocks exactly half the one rank's but for the leaves no rule
       splits (q_norm/k_norm), each step's loss within SHARD_BAND, launch
       counts held to steps x train_launches on each rank; per-rank peak
       memory, step wall, and the collectives' share of a step (the
       layout's ``collective:*`` ranges in torch.profiler).  Then at f32 on
       smoke qwen3-4b, hubert-xlarge and olmoe-1b-7b, two ranks against one
       rank on the card: loss within 1e-5 relative, every leaf within 1e-4
       of its largest element after SHARD_SMOKE_STEPS steps;
    3. with two cards or more, olmoe-1b-7b at full depth (16 layers), FSDP
       with data = the card count over NCCL; on one card one line says
       that it was skipped and why.

    Returns the two-rank run's launches, summed over the ranks, under
    ``train_sharded:qwen3-4b``."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.distributed import default_rules, layout, shard_params_spec
    from repro_torch.distributed.spawn import run_ranks
    from repro_torch.launch.mesh import LogicalMesh, make_train_mesh
    from repro_torch.models import Model
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig, Trainer,
                                   synthetic_batches)
    from repro_torch.train.optimizer import _walk

    t0 = time.perf_counter()
    tag = f"[sharded] ({smi})"

    # ---- 1. a world of one against the one-device trainer, bit for bit
    small = Model(get_config("qwen3-4b", smoke=True))
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    runs = {}
    for name, target, kw in (("device", dev, {}),
                             ("mesh 1x1", make_train_mesh(device=dev), dict(fsdp=True))):
        tr = Trainer(small, target, TrainConfig(opt=opt, log_every=1), **kw)
        p, st = tr.init(0)
        ms = []
        p, st = tr.fit(p, st, synthetic_batches(small.cfg, DataConfig(2, 64)), 3,
                       log=lambda i, m: ms.append(m))
        runs[name] = (ms, dict(_walk(p)))
    same_m = runs["device"][0] == runs["mesh 1x1"][0]
    same_p = all(torch.equal(runs["device"][1][k], runs["mesh 1x1"][1][k])
                 for k in runs["device"][1])
    if not (same_m and same_p):
        worst = max(((runs["device"][1][k] - runs["mesh 1x1"][1][k]).abs().max().item())
                    for k in runs["device"][1])
        raise AssertionError(f"sharded: a world of one differs from the one-device trainer: "
                             f"metrics equal {same_m}, leaves equal {same_p} (worst {worst:.3e}); "
                             f"{runs['device'][0]} vs {runs['mesh 1x1'][0]}")
    log(f"{tag} world of one (1 x 1 mesh, FSDP) against the one-device Trainer, qwen3-4b smoke "
        f"f32, 3 steps: metrics and {len(runs['device'][1])} leaves equal bit for bit "
        f"(losses {[round(m['loss'], 6) for m in runs['device'][0]]})")
    del runs
    torch.cuda.empty_cache()

    # ---- 2. two ranks on the one card against one rank of the same cut
    full = get_config("qwen3-4b")
    model, opt, one, one_bytes, one_counts, one_step, one_peak = one_rank_width(dev)
    cfg = model.cfg
    # each rank's bytes from the specs: every leaf's block in the param dtype and
    # its two f32 moments
    lm = LogicalMesh((2, 1), ("data", "model"))
    specs = dict(_walk(shard_params_spec(model, default_rules(cfg, lm, fsdp=True))))
    item = torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size() + 2 * 4
    shapes = dict(_walk(model.specs()))
    want_bytes = sum(math.prod(layout.block_shape(shapes[k].shape, specs[k], lm)) * item
                     for k in specs)
    whole_bytes = sum(math.prod(shapes[k].shape) * item for k in specs if not any(specs[k]))
    if one_bytes != sum(math.prod(s.shape) * item for s in shapes.values()):
        raise AssertionError(f"sharded: one rank holds {one_bytes} bytes of params and moments")
    log(f"{tag} one rank: qwen3-4b at full width cut to {SHARD_LAYERS} of {full.num_layers} "
        f"layers ({model.num_params() / 1e9:.3f}B params), {SHARD_B} x {SHARD_S}, "
        f"{SHARD_STEPS} steps: losses {[round(m['loss'], 6) for m in one]}; step mean "
        f"{one_step.mean * 1e3:.3f} ms; params+moments {one_bytes / 1e9:.3f} GB; peak "
        f"{one_peak / 1e9:.3f} GB")

    smoke_jobs = [dict(kind="smoke", cfg=get_config(a, smoke=True),
                       opt=AdamWConfig(**SHARD_OPT32), data=2, batch=4, seq=64,
                       steps=SHARD_SMOKE_STEPS) for a in SHARD_SMOKE]
    jobs = [dict(kind="width", cfg=cfg, opt=opt, data=2, batch=SHARD_B, seq=SHARD_S,
                 steps=SHARD_STEPS)] + smoke_jobs
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        ranks = run_ranks(_sharded_ranks, 2, init_file=str(Path(d) / "pg"), backend="gloo",
                          args=(jobs, [str(dev)] * 2), timeout=600)
        spawn_s = time.perf_counter() - t1
    per_step = train_launches(model)
    want = {k: SHARD_STEPS * v for k, v in per_step.items()}
    total = dict.fromkeys(KERNELS, 0)
    for r, res in enumerate(ranks):
        w = res[0]
        if w["counts"] != want:
            raise AssertionError(f"sharded: rank {r} launches {w['counts']}, expected {want}")
        for k in KERNELS:
            total[k] += w["counts"][k]
        if w["resident"] != want_bytes:
            raise AssertionError(f"sharded: rank {r} holds {w['resident']} bytes of parameter "
                                 f"and moment blocks, expected {want_bytes} (one rank "
                                 f"{one_bytes}, {whole_bytes} of them in unsplit leaves)")
        rel = band_readings(w["metrics"], one)
        for i, (x, m, m1) in enumerate(zip(rel, w["metrics"], one)):
            band = SHARD_BAND[0] if i == 0 else SHARD_BAND[1]
            if not x <= band:
                raise AssertionError(f"sharded: rank {r} step {i} loss {m['loss']} vs one rank "
                                     f"{m1['loss']} (band {band})")
        coll_ms = sum(v[0] for v in w["collectives"].values())
        rel = [f"{x:.2e}" for x in rel]
        log(f"{tag} rank {r} of 2 on {dev}: resident params+moments {w['resident'] / 1e9:.3f} "
            f"GB ({w['resident'] / one_bytes:.6f} of one rank's; {whole_bytes} bytes in leaves "
            f"no rule splits); losses {[round(m['loss'], 6) for m in w['metrics']]} (relative "
            f"to one rank {rel}, band {SHARD_BAND}); step mean {w['step_ms']:.3f} ms (cv {w['step_cv']:.4f}; one rank "
            f"{one_step.mean * 1e3:.3f} ms); peak {w['peak'] / 1e9:.3f} GB; init {w['init_s']:.1f}s")
        log(f"{tag} rank {r} profiled step {w['prof_wall_ms']:.3f} ms wall: device busy "
            f"{w['busy_ms']:.3f} ms ({w['busy_ms'] / w['prof_wall_ms']:.3f}; {w['copy_ms']:.3f} ms "
            f"of it copies), collectives "
            f"{coll_ms:.3f} ms ({coll_ms / w['prof_wall_ms']:.3f} of the step): "
            + ", ".join(f"{k[11:]} {v[0]:.3f} ms x{v[1]}"
                        for k, v in sorted(w["collectives"].items()))
            + " (gloo on CUDA tensors)")
    nz = lambda c: {k: v for k, v in c.items() if v}  # noqa: E731
    log(f"{tag} two ranks: launches {nz(total)} (a rank a step: {nz(per_step)}); one rank's "
        f"{nz(one_counts)}; spawn to results {spawn_s:.1f}s")

    # ---- f32 smoke: two ranks against one rank on the card
    for j, arch in enumerate(SHARD_SMOKE):
        m1, p1 = _one_rank_smoke(dev, arch, SHARD_SMOKE_STEPS, 4, 64)
        got = ranks[0][1 + j]
        worst_loss = 0.0
        for r in range(2):
            for a, b in zip(ranks[r][1 + j]["metrics"], m1):
                rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
                worst_loss = max(worst_loss, rel)
                if not rel <= SHARD_TOL32["loss"]:
                    raise AssertionError(f"sharded: {arch} smoke rank {r} loss {a['loss']} vs "
                                         f"one rank {b['loss']}")
        worst = max(float(np.abs(got["full"][k] - p1[k]).max()) / max(float(np.abs(p1[k]).max()),
                                                                       1e-30) for k in p1)
        if not worst <= SHARD_TOL32["leaf"]:
            raise AssertionError(f"sharded: {arch} smoke leaves differ by {worst:.3e} of a "
                                 f"leaf's largest element")
        log(f"{tag} {arch} smoke f32, two ranks against one on the card, {SHARD_SMOKE_STEPS} "
            f"steps: loss within {worst_loss:.2e} relative (band 1e-5), every leaf within "
            f"{worst:.2e} of its largest element (band 1e-4); launches a rank "
            f"{nz(got['counts'])}")

    # ---- 3. olmoe-1b-7b at full depth over every card
    n = torch.cuda.device_count()
    if n < 2:
        log(f"{tag} olmoe-1b-7b at full depth over NCCL: skipped, {n} card (it needs two or more: "
            f"the whole model needs about 83 GB on one)")
    else:
        sharded_many_cards(smi, n)
    log(f"{tag} phase {time.perf_counter() - t0:.1f}s")
    return {"train_sharded:qwen3-4b": total}


def sharded_many_cards(smi: str, n: int) -> None:
    """olmoe-1b-7b at full depth (16 layers, 6.919 B) with FSDP at
    data = n, one rank per card over NCCL, global batch n x SHARD_S,
    SHARD_STEPS steps at TRAIN_LR: launches held to steps x
    train_launches on every rank, every metric finite and equal on every
    rank; per rank resident bytes, peak memory, step wall and the
    collectives' share of a profiled step."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.distributed.spawn import run_ranks
    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig

    t0 = time.perf_counter()
    moe = get_config("olmoe-1b-7b")
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=min(20, SHARD_STEPS // 5 + 1),
                      total_steps=SHARD_STEPS)
    job = dict(kind="width", cfg=moe, opt=opt, data=n, batch=n, seq=SHARD_S, steps=SHARD_STEPS)
    with tempfile.TemporaryDirectory() as d:
        res = run_ranks(_sharded_ranks, n, init_file=str(Path(d) / "pg"), backend="nccl",
                        args=([job], [f"cuda:{r}" for r in range(n)]), timeout=900)
    pm = Model(moe)
    want = {k: SHARD_STEPS * v for k, v in train_launches(pm).items()}
    for r, rr in enumerate(res):
        w = rr[0]
        if w["counts"] != want:
            raise AssertionError(f"sharded: olmoe rank {r} launches {w['counts']}, expected {want}")
        if not all(math.isfinite(v) for m in w["metrics"] for v in m.values()):
            raise AssertionError(f"sharded: olmoe rank {r} metrics not finite: {w['metrics']}")
        if w["metrics"] != res[0][0]["metrics"]:
            raise AssertionError(f"sharded: olmoe ranks 0 and {r} report other metrics")
        coll_ms = sum(v[0] for v in w["collectives"].values())
        log(f"[sharded] ({smi}) olmoe-1b-7b at full depth ({moe.num_layers} layers, "
            f"{pm.num_params() / 1e9:.3f}B params), FSDP data={n} over NCCL, rank {r} on "
            f"cuda:{r}: losses {[round(m['loss'], 6) for m in w['metrics']]}; "
            f"drop_fraction {[round(m['drop_fraction'], 4) for m in w['metrics']]}; resident "
            f"params+moments {w['resident'] / 1e9:.3f} GB; peak {w['peak'] / 1e9:.3f} GB; step "
            f"mean {w['step_ms']:.3f} ms (cv {w['step_cv']:.4f}); profiled step "
            f"{w['prof_wall_ms']:.3f} ms, device busy {w['busy_ms']:.3f} ms ({w['copy_ms']:.3f} ms "
            f"copies, {w['nccl_ms']:.3f} ms NCCL kernels); collectives' host ranges "
            f"{coll_ms:.3f} ms (NCCL returns once enqueued); launches "
            f"{({k: v for k, v in w['counts'].items() if v})}")
    log(f"[sharded] ({smi}) olmoe-1b-7b over {n} cards {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------- phase 11
def phase_cert(dev, smi: str) -> None:
    """The static certifier's claims on the card (module docstring, phase
    11): each batched rung of the default envelope at each declared shard
    count swept through a real engine on the card whose step runs behind a
    signature recorder (``certify_rung(..., execute=True)``): one capture
    per shard, no new signature after warmup, the committed signatures;
    then ``measure_steps`` for every (rung, batch size) against the
    committed floor, which must not exceed it."""
    from repro_torch.analysis.cert import certify_rung, default_envelope, load_certificate, \
        measure_steps
    from repro_torch.analysis.cert.certificate import DEFAULT_CERT_PATH

    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True        # torch's default, as phases 5 to 7b
    t0 = time.perf_counter()
    try:
        env = default_envelope()
        cert = load_certificate(Path(__file__).resolve().parent / DEFAULT_CERT_PATH)
        for k in env.fleet_shards:
            for point in env.rungs:
                trace = certify_rung(point, env, shards=k, device=dev, execute=True)
                (name, prog), = trace.programs.items()
                want = cert["programs"][name]["signatures"]
                if trace.violations or trace.step_captures != k or prog.signatures != want:
                    raise AssertionError(
                        f"cert {name}: violations {trace.violations}, captures "
                        f"{trace.step_captures} (want {k}), signatures {prog.signatures} "
                        f"(committed {want})")
                log(f"[cert] {name} on the card: {prog.calls} step calls over the envelope's "
                    f"occupancy and churn sweep, {trace.step_captures} capture(s) for {k} "
                    f"shard(s), 0 new signatures after warmup, signatures {prog.signatures}")
        bench = measure_steps(env, dev)
        for row in cert["cost_table"]:
            key = (row["rung"], row["batch_size"])
            floor, meas = row["floor_s"] * 1e3, bench[key] * 1e3
            log(f"[cert] {key[0]}/batch{key[1]}: floor {floor:.4f} ms (flops {row['flops']:.0f}, "
                f"bytes {row['bytes_min']:.0f}, h2d {row['h2d_bytes']:.0f} on "
                f"{cert['hardware']['name']}), measured {meas:.4f} ms (device time of a "
                f"whole-capacity submit, median), floor / measured {floor / meas:.4f}; "
                f"committed p50 {row['bench_p50_s'] * 1e3 if row['bench_p50_s'] else 0.0:.4f} "
                f"ms; card {smi}")
            if floor > meas:
                raise AssertionError(f"cert {key}: floor {floor} ms above the measured {meas} ms")
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    log(f"[cert] {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------- phase 12
ROOFLINE_ARCH = "qwen3-4b"


def phase_roofline(smi: str, measured: dict) -> None:
    """qwen3-4b's prefill, decode step and train step counted at the shapes
    phases 3 and 9 measured them (module docstring, phase 12), against
    ``measured`` (per path: device ms, the profiler's summed kernel time of
    one, and wall ms)."""
    from repro_torch.configs import InputShape
    from repro_torch.distributed.mesh import LogicalMesh
    from repro_torch.launch.lowering import build_lowered
    from repro_torch.launch.roofline import H100_SXM, analyze

    t0 = time.perf_counter()
    one = LogicalMesh((1, 1), ("data", "model"))
    shapes = {"prefill": InputShape(f"prefill_{B}x{S_PREFILL}", S_PREFILL, B, "prefill"),
              "decode step": InputShape(f"decode_{B}x{CONTEXT}", CONTEXT, B, "decode"),
              "train step": InputShape(f"train_{TRAIN_B}x{TRAIN_S}", TRAIN_S, TRAIN_B, "train")}
    for name, shape in shapes.items():
        rep = analyze(build_lowered(ROOFLINE_ARCH, shape, one))
        busy, wall = measured[name]["busy_ms"], measured[name]["wall_ms"]
        mfu = rep.model_flops_global / (wall / 1e3 * H100_SXM.peak("bf16"))
        comp, mem = rep.compute_s * 1e3, rep.memory_s * 1e3
        log(f"[roofline] {ROOFLINE_ARCH} {name} ({shape.global_batch} x {shape.seq_len}, "
            f"{rep.kind}): counted {rep.flops_per_device:.4e} flops (kernels {rep.kernels}), "
            f"model_flops {rep.model_flops_global:.4e}; floors compute {comp:.3f} ms, memory "
            f"{mem:.3f} ms (raw {rep.memory_raw_s * 1e3:.3f}); measured device {busy:.3f} ms, "
            f"wall {wall:.3f} ms; floor / device {max(comp, mem) / busy:.4f}; mfu {mfu:.4f}; "
            f"card {smi}")
        if max(comp, mem) > busy:
            raise AssertionError(f"roofline {name}: floor {max(comp, mem)} ms above the device "
                                 f"time {busy} ms")
    log(f"[roofline] {time.perf_counter() - t0:.1f}s")


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
    roof_measured = {}
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
            measured = phase_profile(model, params, dev, rep["mean_s"], min(pre) / 1e3)
            if arch == ROOFLINE_ARCH:
                roof_measured = measured
        del model, params, batch
        torch.cuda.empty_cache()
    for arch in SMOKE_ONLY:
        phase_smoke(dev, arch)
    phase_perception(dev)
    phase_batched(dev)
    phase_scenarios(dev)
    phase_chaos(dev, smi)
    phase_fleet(dev, smi)
    mt_decode = phase_multi_tenant(dev)
    launches["decode_attention"] += mt_decode
    for name in KERNELS:
        by_path[name]["multi_tenant"] = mt_decode if name == "decode_attention" else 0
    for arch, res in phase_train(dev, smi).items():
        for name in KERNELS:
            launches[name] += res["counts"][name]
            by_path[name][f"train:{arch}"] = res["counts"][name]
        if arch == ROOFLINE_ARCH:
            roof_measured["train step"] = dict(busy_ms=res["busy_ms"], wall_ms=res["step_ms"])
    for path, counts in phase_sharded_train(dev, smi).items():
        for name in KERNELS:
            launches[name] += counts[name]
            by_path[name][path] = counts[name]
    phase_cert(dev, smi)
    phase_roofline(smi, roof_measured)
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
