#!/usr/bin/env python3
"""Where a tile's time goes in the two scan kernels, on the card.

    python3 tools/scan_phases.py

Copies ``src/repro_torch/kernels/csrc`` into a build directory and, in
the copy only, puts ``clock64()`` stamps between the phases of each
sub-tile (SSD) or fold tile (WKV): lane 0 of every warp adds the cycles
since its last stamp to that phase, and the block adds its warps' sums
to a device array at exit.  The committed sources are not changed.  The
scores kernel of the WKV call gets one extra barrier in the copy, after
its scans, so that its scans and its pairwise phase are told apart.

Prints, at the full-width shapes of ``chip_smoke.py`` (mamba2 x
(4,1024,80,64), N 64; rwkv6 (4,1024,40,64)), each phase's cycles per
block and tile for every warp of a block, the time of each
call with and without the stamps, and each call's first kernel (the
shared scores) timed alone.  The stamps are anchored on comment lines of
the sources; when a source changes, the anchors here change with it.
Needs one CUDA device and nvcc, like the kernels themselves.
"""
from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

BUILD = _build.BUILD_DIR / "phases"
SLOTS = 12
WARPS = 8         # the most warps a scan block has

HEADER = f"""
#define PHASE_WARPS {WARPS}
__device__ unsigned long long g_phase[PHASE_WARPS][{SLOTS}];
#define STAMP(i) do {{ if ((threadIdx.x & 31) == 0) {{ long long n_ = clock64(); \\
    ph[i] += n_ - t_; t_ = n_; }} }} while (0)
#define STAMP_INIT long long ph[{SLOTS}] = {{0}}; long long t_ = clock64()
#define STAMP_FLUSH(lo, hi) do {{ if ((threadIdx.x & 31) == 0) for (int i = lo; i < hi; ++i) \\
    atomicAdd(&g_phase[threadIdx.x >> 5][i], (unsigned long long)ph[i]); }} while (0)
"""
FOOTER = f"""
extern "C" int read_phases(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, repro_torch::g_phase, sizeof(unsigned long long) * PHASE_WARPS * {SLOTS});
  unsigned long long z[PHASE_WARPS * {SLOTS}] = {{0}};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(repro_torch::g_phase, z, sizeof(z));
  return (int)e;
}}
"""

# (anchor, phase name): a stamp goes just before each anchor; the phase
# named is the code that runs up to it
SSD = [
    ("    if (it + 1 < ntiles)\n      load_tile(", "barrier + state write"),
    ("    // this warp's rows of C·Bᵀ", "cp.async issue"),
    ("    cp_async_wait<1>();\n    __syncthreads();  // this sub-tile", "C·Bᵀ rows from L2"),
    ("    // decay scans: warp 0", "wait + barrier"),
    ("    // C·hᵀ (rows ta, tb) and the fold", "scans (warps 0, 1) + barrier"),
    ("    // y = G·x + exp(cum) (C·hᵀ)", "C·hᵀ + fold"),
    ("    __syncthreads();  // every read of the old state", "gate + G·x + y store"),
]
WKV = [
    ("    if (it + 1 < ntiles)\n      load(it + 1);", "barrier + state write"),
    ("    cp_async_wait<1>();\n    __syncthreads();  // this tile landed", "cp.async issue"),
    ("    // decay scans: thread (sub-block, channel); the tile's prefix", "wait + barrier"),
    ("    // y rows 16mt.., columns 8nt..: A·V", "scans + barrier"),
    ("    // the fold: state rows 16w..", "y"),
    ("    __syncthreads();  // every read of the old state", "fold"),
]
WKV_SCORES = [
    ("  // decay scans: thread (sub-block, channel), 2K of them", "load + wait"),
    ("  // diagonal sub-blocks: pairwise (u < t)", "scans + barrier"),
    ("  float* out = amat + ", "pairwise + off-diagonal product + barrier"),
]


def _stamp(src: str, anchors, first: int) -> str:
    for i, (anchor, _) in enumerate(anchors):
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in the source: {anchor!r}")
        src = src.replace(anchor, f"STAMP({first + i});\n{anchor}")
    return src


def _after_first(src: str, marker: str, text: str) -> str:
    i = src.index(marker) + len(marker)
    return src[:i] + text + src[i:]


def instrument() -> dict[str, Path]:
    """Stamped copies of the two scan sources, built; plus, for timing the
    first kernel of each call alone, an unstamped copy with one more entry."""
    BUILD.mkdir(parents=True, exist_ok=True)
    csrc = _build.CSRC
    for h in csrc.glob("*.cuh"):
        shutil.copy(h, BUILD / h.name)
    ssd = (csrc / "mamba2_ssd.cu").read_text()
    wkv = (csrc / "rwkv6_scan.cu").read_text()

    s = _stamp(ssd, SSD, 0)
    s = _after_first(s, "  const int ntiles = (S + T - 1) / T;\n", "  STAMP_INIT;\n")
    s = s.replace("  cp_async_wait<0>();\n}", f"  cp_async_wait<0>();\n  STAMP_FLUSH(0, {len(SSD)});\n}}")
    s = s.replace("namespace {\n", "namespace {\n" + HEADER, 1) + FOOTER
    (BUILD / "mamba2_ssd_stamped.cu").write_text(s)

    w = _stamp(wkv, WKV, 0)
    w = _after_first(w, "  const int ntiles = (S + TS - 1) / TS;\n", "  STAMP_INIT;\n")
    w = w.replace("  cp_async_wait<0>();\n}", f"  cp_async_wait<0>();\n  STAMP_FLUSH(0, {len(WKV)});\n}}")
    first = len(WKV)
    w = _stamp(w, WKV_SCORES, first)
    w = w.replace("STAMP(%d);\n  // diagonal sub-blocks" % (first + 1),
                  "  __syncthreads();\nSTAMP(%d);\n  // diagonal sub-blocks" % (first + 1))
    w = _after_first(w, "  const int it = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t0 = it * TS;\n",
                     "  STAMP_INIT;\n")
    end = w.index("\n}\n", w.index("  float* out = amat + "))
    w = w[:end] + f"\nSTAMP({first + len(WKV_SCORES)});\n" \
        f"  STAMP_FLUSH({first}, {first + len(WKV_SCORES) + 1});" + w[end:]
    w = w.replace("namespace {\n", "namespace {\n" + HEADER, 1) + FOOTER
    (BUILD / "rwkv6_scan_stamped.cu").write_text(w)

    # the first kernel of each call alone, unstamped
    (BUILD / "mamba2_ssd_split.cu").write_text(ssd + """
extern "C" int scores_only(const void* bmat, const void* cmat, void* scratch, int B, int S,
                           int N, void* stream) {
  using namespace repro_torch;
  ssd_scores_kernel<<<dim3((S + T - 1) / T, B), SCORE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)bmat, (const float*)cmat, (float*)scratch, S, N);
  return (int)cudaGetLastError();
}
""")
    (BUILD / "rwkv6_scan_split.cu").write_text(wkv + """
extern "C" int scores_only(const void* r, const void* k, const void* logw, const void* u,
                           void* scratch, int B, int S, int H, int K, void* stream) {
  using namespace repro_torch;
  static int done = 0;
  cudaError_t err = allow_smem(wkv_scores_kernel, SCORE_SMEM_BYTES, done);
  if (err != cudaSuccess) return (int)err;
  wkv_scores_kernel<<<dim3((S + TS - 1) / TS, H, B), THREADS, SCORE_SMEM_BYTES,
                      (cudaStream_t)stream>>>((const float*)r, (const float*)k,
                                               (const float*)logw, (const float*)u,
                                               (float*)scratch, S, H, K);
  return (int)cudaGetLastError();
}
""")
    nvcc = _build.find_nvcc()
    names = ("mamba2_ssd_stamped", "rwkv6_scan_stamped", "mamba2_ssd_split", "rwkv6_scan_split")
    procs = {n: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(BUILD), "-o",
                                  str(BUILD / f"{n}.so"), str(BUILD / f"{n}.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for n in names}
    for n, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {n}:\n{err}")
    return {n: BUILD / f"{n}.so" for n in names}


def median_ms(fn, rounds: int = 5, iters: int = 20) -> tuple[float, float, float]:
    """Median, min and max over ``rounds`` of the mean time of ``iters``
    calls between CUDA events (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times), min(times), max(times)


def report(buf, rows, first: int, count: int, warps: int, label: str) -> None:
    """Each phase's cycles summed over blocks, over ``count``, per warp."""
    print(f"[phases] {label}, warps 0-{warps - 1}:")
    total = [0.0] * warps
    for i, phase in enumerate(rows):
        vals = [buf[wp * SLOTS + first + i] / count for wp in range(warps)]
        total = [t + v for t, v in zip(total, vals)]
        print(f"[phases]   {phase:42s} " + " ".join(f"{v:9.0f}" for v in vals))
    print(f"[phases]   {'total':42s} " + " ".join(f"{v:9.0f}" for v in total))


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device", file=sys.stderr)
        return 1
    libs = {n: ctypes.CDLL(str(p)) for n, p in instrument().items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[phases] {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}")

    # zamba2-2.7b's prefill scan
    b, s, h, p, n = 4, 1024, 80, 64, 64
    x, dt, a = rn(b, s, h, p), F.softplus(rn(b, s, h)), -torch.exp(rn(h) * 0.2)
    bm, cm, y = rn(b, s, n), rn(b, s, n), torch.empty(b, s, h, p, device=dev)
    ssd_scratch = torch.empty(b * (s // 64) * 64 * 64, device=dev)
    ssd = dict(fn="mamba2_ssd_fwd", anchors=[ph for _, ph in SSD],
               args=[ptr(t) for t in (x, dt, a, bm, cm, y, ssd_scratch)] + [b, s, h, p, n],
               argtypes=[ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
               count=h * b * (p // 32) * (s // 64), warps=8,
               scores=(lambda lib: lib.scores_only(ptr(bm), ptr(cm), ptr(ssd_scratch), b, s, n,
                                                   stream)))
    # rwkv6-3b's prefill scan
    hw, k = 40, 64
    r, kk, v, w = rn(b, s, hw, k), rn(b, s, hw, k), rn(b, s, hw, k), rn(b, s, hw, k)
    logw, u = -F.softplus(w * 0.5), rn(hw, k)
    yw = torch.empty_like(r)
    wkv_scratch = torch.empty(b * hw * (s // 32) * 32 * 32, device=dev)
    wkv = dict(fn="rwkv6_wkv_fwd", anchors=[ph for _, ph in WKV],
               args=[ptr(t) for t in (r, kk, v, logw, u, yw, wkv_scratch)] + [b, s, hw, k],
               argtypes=[ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
               count=hw * b * (k // 16) * (s // 32), warps=4,
               scores=(lambda lib: lib.scores_only(ptr(r), ptr(kk), ptr(logw), ptr(u),
                                                   ptr(wkv_scratch), b, s, hw, k, stream)))
    for name, run in (("mamba2_ssd", ssd), ("rwkv6_scan", wkv)):
        for variant in ("split", "stamped"):
            lib = libs[f"{name}_{variant}"]
            fn = getattr(lib, run["fn"])
            fn.argtypes, fn.restype = run["argtypes"], ctypes.c_int
            call = lambda: fn(*run["args"], stream)  # noqa: E731
            med, lo, hi = median_ms(call)
            print(f"[phases] {name} call, {variant} build: median {med:.4f} ms, "
                  f"range {lo:.4f}-{hi:.4f}")
            if variant == "split":
                med, lo, hi = median_ms(lambda: run["scores"](lib))
                print(f"[phases] {name} first kernel (the shared scores) alone: median "
                      f"{med:.4f} ms, range {lo:.4f}-{hi:.4f}")
                continue
            buf = (ctypes.c_ulonglong * (WARPS * SLOTS))()
            lib.read_phases(buf)          # clears what the timing rounds added
            call()
            torch.cuda.synchronize()
            if lib.read_phases(buf):
                raise RuntimeError("reading the phase counters failed")
            report(buf, run["anchors"], 0, run["count"], run["warps"],
                   f"{name} scan kernel, cycles per block and tile")
            if name == "rwkv6_scan":
                report(buf, [ph for _, ph in WKV_SCORES] + ["A written out"], len(WKV),
                       b * hw * (s // 32), 4, f"{name} scores kernel, cycles per block (one tile)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
