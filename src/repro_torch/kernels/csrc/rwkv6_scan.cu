// RWKV6 WKV scan forward for Hopper (sm_90a), from a zero state:
// r, k, v, logw (B,S,H,K) f32 with logw <= 0, bonus u (H,K) f32 → y (B,S,H,K) f32.
//
//   y_t = r_t · (S + diag(u) k_t v_tᵀ),   S ← diag(exp(logw_t)) S + k_t v_tᵀ
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_wkv_fwd (body
// `_kernel`, fold `_fold_tile`).  Same function and the same fold: the
// sequence is walked in tiles of ts = min(chunk, 32) rows; per tile
//   A[t][u] = Σ_k r[t,k] k[u,k] exp(cum_excl[t,k] − cum[u,k])   (u < t)
//   A[t][t] = Σ_k r[t,k] u[k] k[t,k]
//   y[t]    = Σ_{u≤t} A[t][u] v[u] + (r[t] ⊙ exp(cum_excl[t])) · S
//   S       = diag(exp(total)) S + Σ_u (k[u] ⊙ exp(suffix[u])) v[u]ᵀ
// with suffix[u] = Σ_{j>u} logw[j] summed directly from the tile's end, not
// as total − cum[u] (the TPU kernel's own numerics fix: the difference of
// two large prefix sums loses the low bits of exactly the exponents near 0).  Every
// exponent is <= 0, so logw = −25 stays finite.  The wrapper passes ts; the
// chunk itself only decides ts, as in the TPU kernel, whose grid steps over
// chunks but folds the state through the same ts-row tiles.
//
// What bounds it on the H100: per (b, s, h) it reads 4·K floats and writes
// K, and the recurrence needs ~4·K² flops on them (one rank-1 update of the
// state and one read of it), ~13 per byte moved at K = 64, below the f32
// CUDA-core balance (67 TFLOP/s over 3.35 TB/s = 20), so the bound is the
// memory rate; the kernel's chunked form does a little more arithmetic.
// The TPU kernel keeps the (K×K) state in VMEM across a sequential grid
// axis.  Hopper has no sequential grid, so one block per (batch, head)
// loops over the tiles itself and keeps the 64×64 f32 state (16 KB) in
// shared memory: each input byte is read from device memory once and each
// output byte written once.  This first version multiplies with f32 FMAs
// from shared memory (no wgmma, no TMA, no split over the value columns):
// B·H blocks, 160 at rwkv6-3b's batch 4, each walking the whole sequence.
//
// Thread map (256 threads, 16 × 16): the y phase gives lane group
// ty = tid/16 rows 2ty, 2ty+1 and lane tx = tid%16 columns tx + 16q; the
// state phase gives ty state rows 4ty..4ty+3 and tx the same columns.
// Tile rows are padded to K+1 floats so column walks are conflict-free.

#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int MAX_T = 32;       // fold tile rows (the TPU kernel's _STATE_TILE)
constexpr int MAX_K = 64;       // head width
constexpr int KP = MAX_K + 1;   // padded row stride of the tile arrays
constexpr int AP = MAX_T + 1;   // padded row stride of A
constexpr int THREADS = 256;
constexpr int TILE = MAX_T * KP;

// r, k, v, logw, exclusive prefix, inclusive prefix, r·exp(prefix),
// k·exp(suffix) tiles; A; the state; u and exp(total)
constexpr int SMEM_FLOATS = 8 * TILE + MAX_T * AP + MAX_K * KP + 2 * MAX_K;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

__global__ void __launch_bounds__(THREADS)
wkv_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u, float* __restrict__ y, int S,
               int H, int K, int T) {
  extern __shared__ float smem[];
  float* sR = smem;
  float* sK = sR + TILE;
  float* sV = sK + TILE;
  float* sW = sV + TILE;      // logw
  float* sEx = sW + TILE;     // exclusive prefix of logw
  float* sIn = sEx + TILE;    // inclusive prefix of logw
  float* sRW = sIn + TILE;    // r ⊙ exp(exclusive prefix)
  float* sKW = sRW + TILE;    // k ⊙ exp(exclusive suffix)
  float* sA = sKW + TILE;     // MAX_T x AP
  float* sS = sA + MAX_T * AP;  // K x KP state
  float* sU = sS + MAX_K * KP;
  float* sDec = sU + MAX_K;   // exp(total) per state row

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t step = (size_t)H * K;                    // between positions
  const size_t base = ((size_t)b * S * H + h) * K;      // (b, 0, h, 0)

  for (int i = tid; i < MAX_K * KP; i += THREADS) sS[i] = 0.f;
  for (int i = tid; i < K; i += THREADS) sU[i] = u[(size_t)h * K + i];

  for (int t0 = 0; t0 < S; t0 += T) {
    __syncthreads();  // init visible; the previous tile's readers done
    for (int i = tid; i < T * K; i += THREADS) {
      const int t = i / K, c = i % K;
      const size_t off = base + (size_t)(t0 + t) * step + c;
      sR[t * KP + c] = r[off];
      sK[t * KP + c] = k[off];
      sV[t * KP + c] = v[off];
      sW[t * KP + c] = logw[off];
    }
    __syncthreads();

    // column scans over the tile: prefix sums by the first K threads,
    // suffix sums by K threads of the second half, concurrently
    if (tid < K) {
      float acc = 0.f;
      for (int t = 0; t < T; ++t) {
        const int o = t * KP + tid;
        sEx[o] = acc;
        sRW[o] = sR[o] * expf(acc);
        acc += sW[o];
        sIn[o] = acc;
      }
    } else if (tid >= THREADS / 2 && tid < THREADS / 2 + K) {
      const int c = tid - THREADS / 2;
      float acc = 0.f;  // Σ_{j>t} logw[j]
      for (int t = T - 1; t >= 0; --t) {
        const int o = t * KP + c;
        sKW[o] = sK[o] * expf(acc);
        acc += sW[o];
      }
      sDec[c] = expf(acc);
    }
    __syncthreads();

    // A: pairwise decayed scores below the diagonal, the bonus on it
    for (int i = tid; i < T * T; i += THREADS) {
      const int t = i / T, uu = i % T;
      float a = 0.f;
      if (uu < t) {
        for (int c = 0; c < K; ++c)
          a = fmaf(sR[t * KP + c] * sK[uu * KP + c],
                   expf(sEx[t * KP + c] - sIn[uu * KP + c]), a);
      } else if (uu == t) {
        for (int c = 0; c < K; ++c) a = fmaf(sR[t * KP + c] * sU[c], sK[t * KP + c], a);
      }
      sA[t * AP + uu] = a;
    }
    __syncthreads();

    // y rows 2ty, 2ty+1, columns tx + 16q: intra-tile term, then the state read
    {
      float acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
      const int r0 = 2 * ty;
      const int u_end = min(r0 + 2, T);
      for (int uu = 0; uu < u_end; ++uu) {
        const float a0 = sA[r0 * AP + uu], a1 = sA[(r0 + 1) * AP + uu];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float vv = sV[uu * KP + tx + 16 * q];
          acc[0][q] = fmaf(a0, vv, acc[0][q]);
          acc[1][q] = fmaf(a1, vv, acc[1][q]);
        }
      }
#pragma unroll 4
      for (int c = 0; c < K; ++c) {
        const float w0 = sRW[r0 * KP + c], w1 = sRW[(r0 + 1) * KP + c];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float sv = sS[c * KP + tx + 16 * q];
          acc[0][q] = fmaf(w0, sv, acc[0][q]);
          acc[1][q] = fmaf(w1, sv, acc[1][q]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (r0 + i >= T) continue;
        float* yrow = y + base + (size_t)(t0 + r0 + i) * step;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (tx + 16 * q < K) yrow[tx + 16 * q] = acc[i][q];
      }
    }
    __syncthreads();  // every y read of the state is done

    // state rows 4ty..4ty+3, columns tx + 16q: decay, then fold the tile in
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * ty + i;
        const float dec = c < K ? sDec[c] : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = sS[c * KP + tx + 16 * q] * dec;
      }
      for (int uu = 0; uu < T; ++uu) {
        float kw[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kw[i] = sKW[uu * KP + 4 * ty + i];
#pragma unroll
        for (int q = 0; q < 4; ++q) vv[q] = sV[uu * KP + tx + 16 * q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(kw[i], vv[q], acc[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (4 * ty + i < K && tx + 16 * q < K) sS[(4 * ty + i) * KP + tx + 16 * q] = acc[i][q];
    }
  }
}

}  // namespace
}  // namespace repro_torch

// All tensors f32 and contiguous on one device.  K a multiple of 16 up to
// 64; 1 <= ts <= 32 and S % ts == 0.  Returns cudaGetLastError() after the
// launch.
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                             const void* logw, const void* u, void* y, int B,
                             int S, int H, int K, int ts, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || K > MAX_K || K % 16 || ts < 1 ||
      ts > MAX_T || S % ts)
    return (int)cudaErrorInvalidValue;
  static int smem_done = 0;
  cudaError_t err = allow_smem(wkv_fwd_kernel, SMEM_BYTES, smem_done);
  if (err != cudaSuccess) return (int)err;
  wkv_fwd_kernel<<<dim3(H, B), THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)logw,
      (const float*)u, (float*)y, S, H, K, ts);
  return (int)cudaGetLastError();
}
