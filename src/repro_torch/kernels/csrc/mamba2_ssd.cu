// Mamba2 SSD scan forward for Hopper (sm_90a), from a zero state, one B/C
// group: x (B,S,H,P), dt (B,S,H), a (H,) < 0, B and C (B,S,N), all f32
// → y (B,S,H,P) f32, without the D-skip term (the model adds it).
//
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t ⊗ B_t   (P×N per head),   y_t = h_t C_t
//
// Replaces the TPU kernel repro/kernels/mamba2_ssd.py::mamba2_ssd_fwd (body
// `_kernel`).  Same function in the same chunked form, on sub-tiles of
// T = 64 rows: with cum the inclusive prefix of dt·a inside the sub-tile,
//   G[t][u] = (C_t · B_u) exp(cum[t] − cum[u]) dt_u          (u <= t)
//   y[t]    = Σ_{u≤t} G[t][u] x_u + exp(cum[t]) (h C_t)
//   h       = exp(total) h + Σ_u exp(suffix[u]) dt_u x_u ⊗ B_u
// where suffix[u] = Σ_{j>u} dt_j a is summed from the sub-tile's end (the
// TPU kernel takes total − cum[u]; the direct sum cannot cancel).
//
// chunk and head_block: the TPU kernel materialises a (chunk × chunk ×
// head_block) gate tile, 2 MB at zamba2's chunk 256 and head_block 8, far
// beyond the 227 KB of shared memory a block can have.  This kernel never
// does: it walks the sequence in its own 64-row sub-tiles and carries the
// (P×N) state across them, which gives the same result for any chunk (the
// reference's chunk invariance, 1e-4).  A ragged last sub-tile is masked
// (its rows have dt = 0, so they neither decay nor feed the state).  The
// wrapper checks chunk and head_block as the reference does and passes
// neither: a block owns one (batch, head) and computes C·Bᵀ itself, 320
// blocks at zamba2's batch 4 and 80 heads where blocks of 8 heads sharing
// it would be 40 blocks for 132 SMs.  Recomputing C·Bᵀ per head costs a
// quarter more arithmetic.
//
// What bounds it on the H100: per (b, s, h) it reads P + 1 floats (and
// 2N per (b, s) shared by all heads), writes P, and the recurrence needs
// ~4·P·N flops (one rank-1 update of the state and one read of it), ~31
// per byte at P = N = 64, above the f32 CUDA-core balance of ~20, so the
// bound is the f32 rate.  This first version multiplies with f32 FMAs from
// shared memory (no wgmma, no TMA); each thread keeps a 4×4 register tile
// of its outputs so that every two shared-memory reads feed four FMAs.
//
// Thread map (256 threads, 16 × 16): lane group ty = tid/16 owns rows
// 4ty..4ty+3 of G, y (rows t) and of the state (rows p); lane tx = tid%16
// owns columns tx + 16q.  Rows are padded to 65 floats.

#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int T = 64;          // rows per sub-tile
constexpr int MAX_P = 64;
constexpr int MAX_N = 64;
constexpr int RP = 65;         // padded row stride (T, P, N are all <= 64)
constexpr int THREADS = 256;
constexpr int TILE = 64 * RP;

// x, B, C, G and the state tiles; dt, cum, exp(cum), state weights
constexpr int SMEM_FLOATS = 5 * TILE + 4 * T + 1;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ cm, float* __restrict__ y, int S,
               int H, int P, int N) {
  extern __shared__ float smem[];
  float* sX = smem;             // T x RP: x[u][p]
  float* sB = sX + TILE;        // T x RP: B[u][n]
  float* sC = sB + TILE;        // T x RP: C[t][n]
  float* sG = sC + TILE;        // T x RP: G[t][u]
  float* sH = sG + TILE;        // P x RP: h[p][n]
  float* sDt = sH + TILE;       // T
  float* sCum = sDt + T;        // T inclusive prefix of dt·a
  float* sEc = sCum + T;        // T exp(cum)
  float* sWt = sEc + T;         // T exp(suffix) · dt
  float* sTot = sWt + T;        // 1 exp(total)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float ah = a[h];

  for (int i = tid; i < TILE; i += THREADS) sH[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += T) {
    const int rows = min(T, S - t0);
    __syncthreads();  // init visible; the previous sub-tile's readers done
    for (int i = tid; i < T * P; i += THREADS) {
      const int t = i / P, p = i % P;
      sX[t * RP + p] = t < rows ? x[(((size_t)b * S + t0 + t) * H + h) * P + p] : 0.f;
    }
    for (int i = tid; i < T * N; i += THREADS) {
      const int t = i / N, n = i % N;
      const size_t off = ((size_t)b * S + t0 + t) * N + n;
      sB[t * RP + n] = t < rows ? bm[off] : 0.f;
      sC[t * RP + n] = t < rows ? cm[off] : 0.f;
    }
    for (int t = tid; t < T; t += THREADS)
      sDt[t] = t < rows ? dt[((size_t)b * S + t0 + t) * H + h] : 0.f;
    __syncthreads();

    // prefix sums by thread 0, suffix sums by thread 32 (another warp)
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < T; ++t) {
        acc += sDt[t] * ah;
        sCum[t] = acc;
        sEc[t] = expf(acc);
      }
    } else if (tid == 32) {
      float acc = 0.f;  // Σ_{j>t} dt_j a
      for (int t = T - 1; t >= 0; --t) {
        sWt[t] = expf(acc) * sDt[t];
        acc += sDt[t] * ah;
      }
      *sTot = expf(acc);
    }
    __syncthreads();

    // G rows 4ty+i, columns u = tx + 16q
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(4 * ty + i) * RP + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = sB[(tx + 16 * q) * RP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(cv[i], bv[q], acc[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int uu = tx + 16 * q;
          sG[t * RP + uu] = uu <= t ? acc[i][q] * expf(sCum[t] - sCum[uu]) * sDt[uu] : 0.f;
        }
      }
    }
    __syncthreads();

    // y rows t = 4ty+i, columns p = tx + 16q: intra-tile term, then the state read
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
      const int u_end = 4 * ty + 4;  // G is zero above the diagonal
      for (int uu = 0; uu < u_end; ++uu) {
        float gv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = sG[(4 * ty + i) * RP + uu];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = sX[uu * RP + tx + 16 * q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(gv[i], xv[q], acc[i][q]);
      }
      float st[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) st[i][q] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(4 * ty + i) * RP + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) hv[q] = sH[(tx + 16 * q) * RP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) st[i][q] = fmaf(cv[i], hv[q], st[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
        if (t >= rows) continue;
        float* yrow = y + (((size_t)b * S + t0 + t) * H + h) * P;
        const float ec = sEc[t];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (tx + 16 * q < P) yrow[tx + 16 * q] = fmaf(ec, st[i][q], acc[i][q]);
      }
    }
    __syncthreads();  // every y read of the state is done

    // state rows p = 4ty+i, columns n = tx + 16q
    {
      const float tot = *sTot;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = sH[(4 * ty + i) * RP + tx + 16 * q] * tot;
      for (int uu = 0; uu < rows; ++uu) {
        const float w = sWt[uu];
        float xv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sX[uu * RP + 4 * ty + i] * w;
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = sB[uu * RP + tx + 16 * q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(xv[i], bv[q], acc[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (4 * ty + i < P && tx + 16 * q < N) sH[(4 * ty + i) * RP + tx + 16 * q] = acc[i][q];
    }
  }
}

}  // namespace
}  // namespace repro_torch

// All tensors f32 and contiguous on one device; P and N at most 64.
// Returns cudaGetLastError() after the launch.
extern "C" int mamba2_ssd_fwd(const void* x, const void* dt, const void* a,
                              const void* bmat, const void* cmat, void* y, int B,
                              int S, int H, int P, int N, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > MAX_P || N <= 0 || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  static int smem_done = 0;
  cudaError_t err = allow_smem(ssd_fwd_kernel, SMEM_BYTES, smem_done);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_kernel<<<dim3(H, B), THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)a, (const float*)bmat,
      (const float*)cmat, (float*)y, S, H, P, N);
  return (int)cudaGetLastError();
}
