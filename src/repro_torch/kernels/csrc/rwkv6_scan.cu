// RWKV6 WKV scan forward for Hopper (sm_90a), from a zero state:
// r, k, v, logw (B,S,H,K) f32 with logw <= 0, bonus u (H,K) f32 → y (B,S,H,K) f32.
//
//   y_t = r_t · (S + diag(u) k_t v_tᵀ),   S ← diag(exp(logw_t)) S + k_t v_tᵀ
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_wkv_fwd (body
// `_kernel`, fold `_fold_tile`).  Same function and the same fold: the
// sequence is walked in fold tiles of TS = 32 rows (the TPU kernel's
// _STATE_TILE); per tile
//   A[t][u] = Σ_k r[t,k] k[u,k] exp(cum_excl[t,k] − cum[u,k])   (u < t)
//   A[t][t] = Σ_k r[t,k] u[k] k[t,k]
//   y[t]    = Σ_{u≤t} A[t][u] v[u] + (r[t] ⊙ exp(cum_excl[t])) · S
//   S       = diag(exp(total)) S + Σ_u (k[u] ⊙ exp(suffix[u])) v[u]ᵀ
// with suffix[u] = Σ_{j>u} logw[j] summed directly from the tile's end, not
// as total − cum[u] (the TPU kernel's own numerics fix: the difference of
// two large prefix sums loses the low bits of exactly the exponents near 0).
// The kernel walks its own fold tile whatever the caller's chunk; a ragged
// last tile is masked (its rows load as r = k = v = 0 and logw = 0, so they
// neither decay nor feed the state).
//
// What bounds it on the H100: per (b, s, h) it reads 4·K floats and writes
// K, and the recurrence needs ~4·K² flops on them (one rank-1 update of the
// state and one read of it): 210 MB against 2.7 GFLOP for rwkv6-3b's
// prefill layer, so the bound is the memory rate (0.063 ms).  The design:
//
// - Two kernels a call.  A depends on neither the state nor the columns of
//   v, so wkv_scores_kernel forms it once per (batch, head, fold tile),
//   fully parallel (5,120 blocks at rwkv6-3b's prefill; 21 MB of scratch),
//   and the scan kernel reads it back.
// - Most of A as a product, every exponent <= 0, every exponent a direct
//   sum.  Each fold tile is cut into 16-row sub-blocks, and the decay scans
//   run inside each sub-block.  For t in sub-block 1 and u in sub-block 0,
//   exp(cum_excl[t] − cum[u]) = exp(cum_excl[t] − c) · exp(c − cum[u]) with c
//   = cum[15], the prefix before sub-block 1: the first factor is sub-block
//   1's own exclusive prefix and the second sub-block 0's own exclusive
//   suffix, both <= 0, so the off-diagonal block is (r ⊙ e₁)·(k ⊙ e₂)ᵀ, a
//   tensor-core product that underflows only where the true value does
//   (logw = −25 stays finite).  Only the two diagonal 16 × 16 sub-blocks
//   take the pairwise per-channel exp (four lanes to a pair) and the bonus
//   on the diagonal.  The tile's prefix, suffix and total are sums of the
//   sub-blocks' own, so no exponent is the difference of two 32-row sums:
//   that difference, not the fold, is what made 64-row folds miss 2e-4.
// - Products on the tensor cores in split TF32 (hopper.cuh): the off-diagonal
//   block of A, A·V, the state read (r ⊙ exp(cum_excl))·S and the fold
//   (k ⊙ exp(suffix))ᵀ·V; one TF32 pass misses the 2e-4 tolerance by 20-60×.
//   The warp-level mma.sync m16n8k8, not wgmma: the 16-row sub-blocks and
//   the 32-row fold tile are below wgmma's 64-row tile, and every operand is
//   split into hi and lo in registers as it is loaded, so shared memory
//   holds one f32 copy of each tile.  The three passes of a product go to
//   three accumulators, so they do not wait on one another.
// - A grid that fills the card: the columns j of the state are independent
//   (column j only ever meets v[:, j]), so a scan block owns (batch, head,
//   16 columns): 640 blocks at rwkv6-3b's batch 4, 40 heads, K = 64, three
//   to an SM (74 KB of shared memory each), where one block per (batch,
//   head) gave 160.
// - Decay scans with every thread busy: 2K threads each walk one channel of
//   one 16-row sub-block, prefix forward and suffix backward from the
//   sub-block's end, and the two sub-blocks exchange their totals through
//   shared memory.  On the H100 this is faster than shuffle scans across
//   rows (lanes holding four rows each), which the shuffles' throughput
//   bounds, not the adds.
// - Asynchronous loads: cp.async brings tile i + 1 (r, k, logw, the block's
//   16 columns of v, its A) into the second of two buffers while tile i
//   computes.
//
// Thread map of the scan kernel (128 threads, 4 warps; g = lane / 4,
// q = lane % 4): scans, thread (sub-block tid / K, channel tid % K); y, warp
// w rows 16(w / 2).. and columns 8(w % 2)..; the fold, warp w state rows
// 16w..16w+15, kept in registers across tiles (written to shared memory
// once per tile for the next one's state read).  Tile rows are padded (K to
// 68, v and the state to 24, A to 36 floats) so fragment loads are free of
// bank conflicts.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int TS = 32;          // fold-tile rows (the TPU kernel's _STATE_TILE)
constexpr int SUB = 16;         // sub-block rows
constexpr int VS = 16;          // state columns per block
constexpr int MAX_K = 64;       // head width
constexpr int KS = MAX_K + 4;   // row stride of the K-wide tiles
constexpr int VSS = VS + 8;     // row stride of v and the state
constexpr int AS = TS + 4;      // row stride of A
constexpr int THREADS = 128;
constexpr int PAIRS = SUB * (SUB + 1) / 2;   // (t, u <= t) in one sub-block
constexpr int NPAIRS = (TS / SUB) * PAIRS;
constexpr float LOG2E = 1.4426950408889634f;

// scores kernel: r, k, logw then the inclusive prefix, the off-diagonal
// factors (TS x KS each); A (TS x AS)
constexpr int SCORE_SMEM_BYTES = (4 * TS * KS + TS * AS) * 4;
// scan kernel, one buffer: r then r ⊙ exp(prefix), k then k ⊙ exp(suffix),
// logw (TS x KS); v (TS x VSS); A (TS x AS)
constexpr int STAGE = 3 * TS * KS + TS * VSS + TS * AS;
// two buffers; the state (K x VSS); exp(total); the sub-blocks' totals
constexpr int SMEM_FLOATS = 2 * STAGE + MAX_K * VSS + MAX_K + 2 * MAX_K;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

// Decay scans inside one 16-row sub-block of one channel, by one thread:
// x[i] is the sub-block's row i of logw in log2 units (rows loaded by
// consecutive lanes for consecutive channels, so no two lanes of a warp
// share a bank).  The prefix is summed forward and the suffix backward from
// the sub-block's end, in order; exc[i] is the same float as the inclusive
// prefix of row i - 1, so a pair's exponent exc[t] - inc[t - 1] is exactly 0.
struct SubScan {
  float exc[SUB], suf[SUB], pre_total, suf_total;
};
__device__ __forceinline__ SubScan sub_scan(const float* w, int row0, int c) {
  float x[SUB];
#pragma unroll
  for (int i = 0; i < SUB; ++i) x[i] = w[(row0 + i) * KS + c] * LOG2E;
  SubScan s;
  float e = 0.f;
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    s.exc[i] = e;
    e = i ? e + x[i] : x[i];
  }
  s.pre_total = e;
  float f = 0.f;
#pragma unroll
  for (int i = SUB - 1; i >= 0; --i) {
    s.suf[i] = f;
    f = i < SUB - 1 ? x[i] + f : x[i];
  }
  s.suf_total = f;
  return s;
}

// barrier 1 among the 2K threads that scan (K a multiple of 16)
__device__ __forceinline__ void named_sync_scan(int K) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(2 * K) : "memory");
}

// cp.async of nrows rows of ncols floats (a power of two, multiple of 4)
// from src (row stride step) into dst (row stride ds); rows past
// valid read as zeros
__device__ __forceinline__ void load_rows(float* dst, int ds, const float* __restrict__ src,
                                          size_t step, int nrows, int ncols, int valid) {
  const int lg = 31 - __clz(ncols / 4);
  for (int i = threadIdx.x; i < nrows * (ncols / 4); i += THREADS) {
    const int t = i >> lg, c = (i & ((ncols / 4) - 1)) * 4;
    const bool ok = t < valid;
    cp_async_16(dst + t * ds + c, src + (ok ? (size_t)t * step + c : 0), ok ? 16 : 0);
  }
}

// The decayed scores A of one fold tile (the part every column block of
// the scan shares): grid (tiles, H, B).  Diagonal sub-blocks pairwise, four
// lanes a pair; the off-diagonal block as a product of the factors.  Rows
// past S are zeros, and so is A above its diagonal.
__global__ void __launch_bounds__(THREADS, 5)
wkv_scores_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ logw, const float* __restrict__ u,
                  float* __restrict__ amat, int S, int H, int K) {
  extern __shared__ __align__(16) float smem[];
  float* sR = smem;
  float* sK = sR + TS * KS;
  float* sW = sK + TS * KS;     // logw, then the sub-block's inclusive prefix
  float* sF = sW + TS * KS;     // rows < SUB: k ⊙ exp(c − prefix); rows >= SUB: r ⊙ exp(excl − c)
  float* sA = sF + TS * KS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int it = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t0 = it * TS;
  const size_t step = (size_t)H * K;
  const size_t base = (((size_t)b * S + t0) * H + h) * K;
  const int valid = min(TS, S - t0);
  load_rows(sR, KS, r + base, step, TS, K, valid);
  load_rows(sK, KS, k + base, step, TS, K, valid);
  load_rows(sW, KS, logw + base, step, TS, K, valid);
  cp_async_commit();
  for (int i = tid; i < TS * AS; i += THREADS) sA[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // decay scans: thread (sub-block, channel), 2K of them
  if (tid < 2 * K) {
    const int sb = tid / K, c = tid % K, row0 = sb * SUB;
    const SubScan s = sub_scan(sW, row0, c);
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int o = (row0 + i) * KS + c;
      sW[o] = i < SUB - 1 ? s.exc[i + 1] : s.pre_total;   // the inclusive prefix
      // exp(cum_excl[t] - c) and exp(c - cum[u]), c the prefix before
      // sub-block 1, are the sub-blocks' own exclusive prefix and suffix
      sF[o] = sb == 0 ? sK[o] * fast_exp2(s.suf[i]) : sR[o] * fast_exp2(s.exc[i]);
    }
  }
  __syncthreads();

  // diagonal sub-blocks: pairwise (u < t), and the bonus on the diagonal;
  // 32 pairs a round, four lanes a pair over channels q, q + 4, ...
  const float* uh = u + (size_t)h * K;
  for (int r0 = 0; r0 < NPAIRS; r0 += THREADS / 4) {
    const int idx = r0 + (tid >> 2);
    float acc0 = 0.f, acc1 = 0.f;
    int t = 0, uu = 0;
    if (idx < NPAIRS) {
      const int sb = idx / PAIRS, pr = idx % PAIRS;
      int tl = (int)((sqrtf(8.f * pr + 1.f) - 1.f) * 0.5f);
      tl += (tl + 1) * (tl + 2) / 2 <= pr;
      tl -= tl * (tl + 1) / 2 > pr;
      t = sb * SUB + tl;
      uu = sb * SUB + pr - tl * (tl + 1) / 2;
      if (uu < t) {
        // the exclusive prefix of row t is the inclusive one of row t - 1
#pragma unroll 4
        for (int c = q; c < K; c += 8) {
          acc0 = fmaf(sR[t * KS + c] * sK[uu * KS + c],
                      fast_exp2(sW[(t - 1) * KS + c] - sW[uu * KS + c]), acc0);
          acc1 = fmaf(sR[t * KS + c + 4] * sK[uu * KS + c + 4],
                      fast_exp2(sW[(t - 1) * KS + c + 4] - sW[uu * KS + c + 4]), acc1);
        }
      } else {
#pragma unroll 4
        for (int c = q; c < K; c += 8) {
          acc0 = fmaf(sR[t * KS + c] * __ldg(uh + c), sK[t * KS + c], acc0);
          acc1 = fmaf(sR[t * KS + c + 4] * __ldg(uh + c + 4), sK[t * KS + c + 4], acc1);
        }
      }
    }
    float acc = acc0 + acc1;
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (idx < NPAIRS && q == 0) sA[t * AS + uu] = acc;
  }
  // the off-diagonal block (rows SUB.., columns ..SUB): F[SUB..]·F[..SUB]ᵀ
  if (warp < 2) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = 0; kk < K / 8; ++kk) {
      const int k0 = 8 * kk + q;
      const float af[4] = {sF[(SUB + g) * KS + k0], sF[(SUB + g + 8) * KS + k0],
                           sF[(SUB + g) * KS + k0 + 4], sF[(SUB + g + 8) * KS + k0 + 4]};
      uint32_t ahi[4], alo[4];
      split_tf32(af, ahi, alo);
      const float bf[2] = {sF[(8 * warp + g) * KS + k0], sF[(8 * warp + g) * KS + k0 + 4]};
      mma_split(acc, ahi, alo, bf);
    }
    const int col = 8 * warp + 2 * q;
    sA[(SUB + g) * AS + col] = acc[0];
    sA[(SUB + g) * AS + col + 1] = acc[1];
    sA[(SUB + g + 8) * AS + col] = acc[2];
    sA[(SUB + g + 8) * AS + col + 1] = acc[3];
  }
  __syncthreads();
  float* out = amat + (((size_t)b * H + h) * gridDim.x + it) * TS * TS;
  for (int i = tid; i < TS * TS / 4; i += THREADS) {
    const int t = i / (TS / 4), c = (i % (TS / 4)) * 4;
    *reinterpret_cast<float4*>(out + t * TS + c) =
        make_float4(sA[t * AS + c], sA[t * AS + c + 1], sA[t * AS + c + 2], sA[t * AS + c + 3]);
  }
}

__global__ void __launch_bounds__(THREADS)
wkv_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ amat, float* __restrict__ y, int S, int H, int K) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem + 2 * STAGE;     // K x VSS: the block's columns of the state
  float* sDec = sS + MAX_K * VSS;   // exp(total) per state row
  float* sTot = sDec + MAX_K;       // sub-block 0's prefix total, sub-block 1's suffix total

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * VS;
  const size_t step = (size_t)H * K;                    // between positions
  const size_t base = ((size_t)b * S * H + h) * K;      // (b, 0, h, 0)
  const int ntiles = (S + TS - 1) / TS;
  const float* abase = amat + ((size_t)b * H + h) * ntiles * TS * TS;

  for (int i = tid; i < MAX_K * VSS; i += THREADS) sS[i] = 0.f;
  float sacc[2][4];   // state rows 16w + g, + 8; columns of tiles 0, 1
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) sacc[j][i] = 0.f;

  auto load = [&](int it) {
    float* st = smem + (it & 1) * STAGE;
    const size_t off = base + (size_t)it * TS * step;
    const int valid = min(TS, S - it * TS);
    load_rows(st, KS, r + off, step, TS, K, valid);
    load_rows(st + TS * KS, KS, k + off, step, TS, K, valid);
    load_rows(st + 2 * TS * KS, KS, logw + off, step, TS, K, valid);
    load_rows(st + 3 * TS * KS, VSS, v + off + j0, step, TS, VS, valid);
    load_rows(st + 3 * TS * KS + TS * VSS, AS, abase + (size_t)it * TS * TS, TS, TS, TS, TS);
    cp_async_commit();
  };
  load(0);

  for (int it = 0; it < ntiles; ++it) {
    float* sR = smem + (it & 1) * STAGE;   // r, then r ⊙ exp(exclusive prefix)
    float* sK = sR + TS * KS;              // k, then k ⊙ exp(exclusive suffix)
    float* sW = sK + TS * KS;
    float* sV = sW + TS * KS;
    float* sA = sV + TS * VSS;
    const int t0 = it * TS;
    if (it + 1 < ntiles)
      load(it + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile landed; the state of the last one is written

    // decay scans: thread (sub-block, channel); the tile's prefix and
    // suffix are the sub-block's own plus the other sub-block's total
    if (tid < 2 * K) {
      const int sb = tid / K, c = tid % K, row0 = sb * SUB;
      const SubScan s = sub_scan(sW, row0, c);
      // sub-block 0's prefix total, sub-block 1's suffix total
      sTot[tid] = sb == 0 ? s.pre_total : s.suf_total;
      named_sync_scan(K);
      const float other = sTot[(1 - sb) * K + c];
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const int o = (row0 + i) * KS + c;
        sR[o] *= fast_exp2(sb == 0 ? s.exc[i] : other + s.exc[i]);
        sK[o] *= fast_exp2(sb == 0 ? s.suf[i] + other : s.suf[i]);
      }
      if (sb == 0) sDec[c] = fast_exp2(s.suf_total + other);
    }
    __syncthreads();

    // y rows 16mt.., columns 8nt..: A·V, then the state read (12 k-steps)
    {
      const int mt = warp >> 1, nt = warp & 1;
      const int m0 = 16 * mt;
      float acc[3][4] = {}, accs[3][4] = {};
#pragma unroll
      for (int j = 0; j < TS / 8; ++j) {
        const int k0 = 8 * j + q;
        const float af[4] = {sA[(m0 + g) * AS + k0], sA[(m0 + g + 8) * AS + k0],
                             sA[(m0 + g) * AS + k0 + 4], sA[(m0 + g + 8) * AS + k0 + 4]};
        uint32_t ahi[4], alo[4];
        split_tf32(af, ahi, alo);
        const float bf[2] = {sV[k0 * VSS + 8 * nt + g], sV[(k0 + 4) * VSS + 8 * nt + g]};
        mma_split3(acc, ahi, alo, bf);
      }
      for (int kk = 0; kk < K / 8; ++kk) {
        const int k0 = 8 * kk + q;
        const float af[4] = {sR[(m0 + g) * KS + k0], sR[(m0 + g + 8) * KS + k0],
                             sR[(m0 + g) * KS + k0 + 4], sR[(m0 + g + 8) * KS + k0 + 4]};
        uint32_t ahi[4], alo[4];
        split_tf32(af, ahi, alo);
        const float bf[2] = {sS[k0 * VSS + 8 * nt + g], sS[(k0 + 4) * VSS + 8 * nt + g]};
        mma_split3(accs, ahi, alo, bf);
      }
      float o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = sum3(acc, i) + sum3(accs, i);
      const int col = j0 + 8 * nt + 2 * q;
      const int ta = t0 + m0 + g, tb = ta + 8;
      if (ta < S)
        *reinterpret_cast<float2*>(y + base + (size_t)ta * step + col) = make_float2(o[0], o[1]);
      if (tb < S)
        *reinterpret_cast<float2*>(y + base + (size_t)tb * step + col) = make_float2(o[2], o[3]);
    }

    // the fold: state rows 16w.., S = diag(exp(total)) S + (k ⊙ exp(suffix))ᵀ·V
    const int c0 = 16 * warp;
    if (c0 < K) {
      const float da = sDec[c0 + g], db = sDec[c0 + g + 8];
      float fa[2][3][4] = {};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        fa[j][2][0] = sacc[j][0] * da;
        fa[j][2][1] = sacc[j][1] * da;
        fa[j][2][2] = sacc[j][2] * db;
        fa[j][2][3] = sacc[j][3] * db;
      }
#pragma unroll
      for (int kk = 0; kk < TS / 8; ++kk) {
        const int k0 = 8 * kk + q;
        const float af[4] = {sK[k0 * KS + c0 + g], sK[k0 * KS + c0 + g + 8],
                             sK[(k0 + 4) * KS + c0 + g], sK[(k0 + 4) * KS + c0 + g + 8]};
        uint32_t ahi[4], alo[4];
        split_tf32(af, ahi, alo);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float bf[2] = {sV[k0 * VSS + 8 * j + g], sV[(k0 + 4) * VSS + 8 * j + g]};
          mma_split3(fa[j], ahi, alo, bf);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sacc[j][i] = sum3(fa[j], i);
    }
    __syncthreads();  // every read of the old state and of this buffer is done
    if (c0 < K) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * j + 2 * q;
        sS[(c0 + g) * VSS + col] = sacc[j][0];
        sS[(c0 + g) * VSS + col + 1] = sacc[j][1];
        sS[(c0 + g + 8) * VSS + col] = sacc[j][2];
        sS[(c0 + g + 8) * VSS + col + 1] = sacc[j][3];
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace
}  // namespace repro_torch

// All tensors f32 and contiguous on one device; K a multiple of 16 up to 64;
// scratch holds B·H·ceil(S/32)·32·32 floats.  Launches two kernels (the
// shared scores, then the scan); returns cudaGetLastError() after them.
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                             const void* logw, const void* u, void* y, void* scratch, int B,
                             int S, int H, int K, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || K > MAX_K || K % 16)
    return (int)cudaErrorInvalidValue;
  static int smem_done = 0, score_smem_done = 0;
  cudaError_t err = allow_smem(wkv_fwd_kernel, SMEM_BYTES, smem_done);
  if (err == cudaSuccess) err = allow_smem(wkv_scores_kernel, SCORE_SMEM_BYTES, score_smem_done);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = (S + TS - 1) / TS;
  wkv_scores_kernel<<<dim3(ntiles, H, B), THREADS, SCORE_SMEM_BYTES, st>>>(
      (const float*)r, (const float*)k, (const float*)logw, (const float*)u, (float*)scratch, S,
      H, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv_fwd_kernel<<<dim3(H, B, K / VS), THREADS, SMEM_BYTES, st>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)logw,
      (const float*)scratch, (float*)y, S, H, K);
  return (int)cudaGetLastError();
}

// Blocks of the scan kernel that fit on one SM at once (the occupancy API),
// its threads and shared memory per block.
extern "C" int rwkv6_wkv_occupancy(int* blocks_per_sm, int* threads, int* smem_bytes) {
  using namespace repro_torch;
  static int smem_done = 0;
  cudaError_t err = allow_smem(wkv_fwd_kernel, SMEM_BYTES, smem_done);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, wkv_fwd_kernel, THREADS,
                                                        SMEM_BYTES);
  *threads = THREADS;
  *smem_bytes = SMEM_BYTES;
  return (int)err;
}
