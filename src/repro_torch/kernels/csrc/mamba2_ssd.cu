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
// state across them, which gives the same result for any chunk (the
// reference's chunk invariance, 1e-4).  A ragged last sub-tile is masked
// (its rows load as zeros, so dt = 0: they neither decay nor feed the
// state).  The wrapper checks chunk and head_block as the reference does
// and passes neither.
//
// What bounds it on the H100: per (b, s, h) it reads P + 1 floats (and 2N
// per (b, s), shared by all heads) and writes P, and the recurrence needs
// ~4·P·N flops (one rank-1 update of the state and one read of it): at
// P = N = 64 that is 171 MB against 5.4 GFLOP for zamba2's prefill layer,
// 0.051 ms at 3.35 TB/s against 0.033 ms of split TF32 (three passes) at
// the tensor cores' 495 TFLOP/s, so the bound is the bytes.  The design:
//
// - Two kernels a call.  C·Bᵀ depends on neither the head nor the state, so
//   ssd_scores_kernel forms it once per (batch, sub-tile), 64 small blocks
//   (1 MB of scratch at zamba2's prefill, read back from L2), where every
//   (batch, head) block would otherwise form it again: 80 times over.
// - Products on the tensor cores in split TF32 (hopper.cuh): C·Bᵀ, the
//   gated G·X, C·hᵀ and the fold (w ⊙ X)ᵀ·B, f32 in and f32 sums; one TF32
//   pass misses the 2e-4 tolerance by ~60× (tests/test_torch_scan_kernels.py).
//   The warp-level mma.sync m16n8k8, not wgmma: every operand is split into
//   hi and lo in registers as it is loaded, so shared memory holds one f32
//   copy of each tile (wgmma reads B from shared memory, so both halves of
//   B, and X transposed, would have to be staged, doubling the tiles and
//   halving the blocks that fit on an SM), and G stays in the registers it
//   is gated in and feeds G·X directly (the permuted k of hopper.cuh).
//   Every loop around a product has a trip count fixed at compile time per
//   warp, so independent products interleave.
// - A grid that fills the card: the state's rows p are independent (row p
//   only ever meets x[:, p]), so a block owns (batch, head, 32 rows of the
//   state): 640 blocks of 256 threads at zamba2's batch 4, 80 heads,
//   P = 64, two to an SM (98 KB of shared memory each), where one block per
//   (batch, head) gave 320 blocks in 1.2 waves.
// - Parallel decay scans: warp 0 forms the 64 prefix sums and warp 1 the
//   64 suffix sums with shuffle scans, two rows a lane (exp2 of log2-scaled
//   sums, ex2.approx).
// - Asynchronous loads: cp.async brings sub-tile i + 1 (C, B, the block's
//   32 columns of x, dt) into the second of two buffers while sub-tile i
//   computes; the warp's rows of C·Bᵀ come from L2 into registers while the
//   scans run.
//
// Thread map of the scan kernel (256 threads, 8 warps; g = lane / 4,
// q = lane % 4): warp w owns rows t = 16 mw.. of G, y and C·hᵀ, mw = w for
// w < 4 and 7 - w after (so that each SM sub-partition holds a light and a
// heavy warp), (G only
// for the column tiles u <= t), for the block's state rows and x columns
// pc = 16(w / 4)..pc+15; and state columns n = 16 mw..+15 of those 16
// state rows, which it keeps in registers across sub-tiles
// (written to shared memory once per sub-tile for the next one's C·hᵀ).
// Tile rows are padded to 68 floats (x to 36) so fragment loads are free of
// bank conflicts.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int T = 64;          // rows per sub-tile
constexpr int PS = 32;         // state rows (columns of x) per block
constexpr int MAX_P = 64;
constexpr int MAX_N = 64;
constexpr int RS = MAX_N + 4;  // row stride of C, B and the state
constexpr int XS = PS + 4;     // row stride of the x columns
constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// one buffer: C, B (T x RS), x (T x XS), dt (T)
constexpr int STAGE = 2 * T * RS + T * XS + T;
// two buffers; the state (PS x RS); prefix, exp(prefix), exp(suffix)·dt (T
// each) and exp(total)
constexpr int SMEM_FLOATS = 2 * STAGE + PS * RS + 3 * T + 4;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

struct Stage {
  float* c;
  float* b;
  float* x;
  float* dt;
  __device__ Stage(float* base)
      : c(base), b(base + T * RS), x(base + 2 * T * RS), dt(base + 2 * T * RS + T * XS) {}
};

// cp.async of sub-tile rows t0..t0+T-1 into st; rows past S and columns past
// N or P read as zeros (C and B always fill 64 columns)
__device__ __forceinline__ void load_tile(const Stage& st, const float* __restrict__ x,
                                          const float* __restrict__ dt,
                                          const float* __restrict__ bm,
                                          const float* __restrict__ cm, int b, int h, int p0,
                                          int t0, int S, int H, int P, int N) {
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int i = tid; i < T * (MAX_N / 4); i += THREADS) {
    const int t = i >> 4, c = (i & 15) * 4;
    const bool ok = t0 + t < S && c < N;
    const size_t off = ok ? ((size_t)b * S + t0 + t) * N + c : 0;
    cp_async_16(st.c + t * RS + c, cm + off, ok ? 16 : 0);
    cp_async_16(st.b + t * RS + c, bm + off, ok ? 16 : 0);
  }
#pragma unroll
  for (int i = tid; i < T * (PS / 4); i += THREADS) {
    const int t = i >> 3, c = (i & 7) * 4;
    const bool ok = t0 + t < S && p0 + c < P;
    const size_t off = ok ? (((size_t)b * S + t0 + t) * H + h) * P + p0 + c : 0;
    cp_async_16(st.x + t * XS + c, x + off, ok ? 16 : 0);
  }
  if (tid < T) {
    const bool ok = t0 + tid < S;
    const size_t off = ok ? ((size_t)b * S + t0 + tid) * H + h : 0;
    cp_async_4(st.dt + tid, dt + off, ok ? 4 : 0);
  }
  cp_async_commit();
}

constexpr int SCORE_THREADS = 128;

__device__ __forceinline__ float warp_scan_up(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// C·Bᵀ of one sub-tile, all 64 × 64 (the part every head shares): grid
// (sub-tiles, batch); warp w rows 16w..16w+15.  Rows past S and columns
// past N are zeros.
__global__ void __launch_bounds__(SCORE_THREADS)
ssd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ cb, int S, int N) {
  __shared__ __align__(16) float sC[T * RS];
  __shared__ __align__(16) float sB[T * RS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int it = blockIdx.x, b = blockIdx.y, t0 = it * T;
  for (int i = tid; i < T * (MAX_N / 4); i += SCORE_THREADS) {
    const int t = i >> 4, c = (i & 15) * 4;
    float4 cv = make_float4(0.f, 0.f, 0.f, 0.f), bv = cv;
    if (t0 + t < S && c < N) {
      const size_t off = ((size_t)b * S + t0 + t) * N + c;
      cv = *reinterpret_cast<const float4*>(cm + off);
      bv = *reinterpret_cast<const float4*>(bm + off);
    }
    *reinterpret_cast<float4*>(sC + t * RS + c) = cv;
    *reinterpret_cast<float4*>(sB + t * RS + c) = bv;
  }
  __syncthreads();
  const int m0 = 16 * warp;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < MAX_N / 8; ++kk) {
    const int k0 = 8 * kk + q;
    const float af[4] = {sC[(m0 + g) * RS + k0], sC[(m0 + g + 8) * RS + k0],
                         sC[(m0 + g) * RS + k0 + 4], sC[(m0 + g + 8) * RS + k0 + 4]};
    uint32_t ahi[4], alo[4];
    split_tf32(af, ahi, alo);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float bf[2] = {sB[(8 * j + g) * RS + k0], sB[(8 * j + g) * RS + k0 + 4]};
      mma_split(acc[j], ahi, alo, bf);
    }
  }
  float* out = cb + ((size_t)b * gridDim.x + it) * T * T;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int u0 = 8 * j + 2 * q;
    *reinterpret_cast<float2*>(out + (m0 + g) * T + u0) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (m0 + g + 8) * T + u0) = make_float2(acc[j][2], acc[j][3]);
  }
}

// The gate in the score registers (rows ta, ta + 8; columns u0, u0 + 1 of
// tiles j < NU), then y += G·x over those tiles: G is the A operand as it
// lies (the permuted k of hopper.cuh).
template <int NU>
__device__ __forceinline__ void gate_gx(float (&sc)[8][4], float (&yi)[2][4], const float* sCum,
                                        const float* sdt, const float* sx, int ta, int g,
                                        int q) {
  const int tb = ta + 8;
  const float ca = sCum[ta], cb = sCum[tb];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int u0 = 8 * j + 2 * q;
    const float cu0 = sCum[u0], cu1 = sCum[u0 + 1];
    const float d0 = sdt[u0], d1 = sdt[u0 + 1];
    const float af[4] = {u0 <= ta ? sc[j][0] * fast_exp2(ca - cu0) * d0 : 0.f,
                         u0 <= tb ? sc[j][2] * fast_exp2(cb - cu0) * d0 : 0.f,
                         u0 + 1 <= ta ? sc[j][1] * fast_exp2(ca - cu1) * d1 : 0.f,
                         u0 + 1 <= tb ? sc[j][3] * fast_exp2(cb - cu1) * d1 : 0.f};
    uint32_t ahi[4], alo[4];
    split_tf32(af, ahi, alo);
#pragma unroll
    for (int pn = 0; pn < 2; ++pn) {
      const float bf[2] = {sx[u0 * XS + 8 * pn + g], sx[(u0 + 1) * XS + 8 * pn + g]};
      mma_split(yi[pn], ahi, alo, bf);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ cb,
               float* __restrict__ y, int S, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* sH = smem + 2 * STAGE;   // PS x RS: state h[p][n]
  float* sCum = sH + PS * RS;     // T: inclusive prefix of dt·a·log2(e)
  float* sEc = sCum + T;          // T: exp(prefix)
  float* sWt = sEc + T;           // T: exp(suffix)·dt
  float* sTot = sWt + T;          // exp(total)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, p0 = blockIdx.z * PS;
  const float ah = a[h];
  // this warp's rows t: 16mw..; the second four warps take the row blocks
  // in reverse order, so that each SM sub-partition (warps w and w + 4)
  // holds one warp with few column tiles u <= t and one with many
  const int mw = warp < 4 ? warp : 7 - warp;
  const int pc = 16 * (warp >> 2);  // and its 16 of the block's columns p
  const int ta = 16 * mw + g, tb = ta + 8;
  const int nu = 2 * mw + 2;      // its column tiles u <= t
  const int ntiles = (S + T - 1) / T;

  for (int i = tid; i < PS * RS; i += THREADS) sH[i] = 0.f;
  float hacc[2][4];               // state rows pc + g, + 8; columns of tiles 2mw, 2mw+1
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) hacc[j][i] = 0.f;

  load_tile(Stage(smem), x, dt, bm, cm, b, h, p0, 0, S, H, P, N);

  for (int it = 0; it < ntiles; ++it) {
    const Stage st(smem + (it & 1) * STAGE);
    const int t0 = it * T;
    if (it + 1 < ntiles)
      load_tile(Stage(smem + ((it + 1) & 1) * STAGE), x, dt, bm, cm, b, h, p0, t0 + T, S, H,
                P, N);
    else
      cp_async_commit();

    // this warp's rows of C·Bᵀ (from ssd_scores_kernel, in L2), in the
    // accumulator layout, loaded while the tile lands and the scans run
    float sc[8][4];
    {
      const float* cbt = cb + ((size_t)b * ntiles + it) * T * T;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float2 va = make_float2(0.f, 0.f), vb = va;
        if (j < nu) {
          va = __ldg(reinterpret_cast<const float2*>(cbt + ta * T + 8 * j + 2 * q));
          vb = __ldg(reinterpret_cast<const float2*>(cbt + tb * T + 8 * j + 2 * q));
        }
        sc[j][0] = va.x;
        sc[j][1] = va.y;
        sc[j][2] = vb.x;
        sc[j][3] = vb.y;
      }
    }
    cp_async_wait<1>();
    __syncthreads();  // this sub-tile landed; the state of the last one is written

    // decay scans: warp 0 the prefix, warp 1 the suffix, rows lane and lane + 32
    if (warp == 0) {
      float v0 = st.dt[lane] * ah * LOG2E, v1 = st.dt[lane + 32] * ah * LOG2E;
      v0 = warp_scan_up(v0, lane);
      v1 = warp_scan_up(v1, lane) + __shfl_sync(0xffffffffu, v0, 31);
      sCum[lane] = v0;
      sCum[lane + 32] = v1;
      sEc[lane] = fast_exp2(v0);
      sEc[lane + 32] = fast_exp2(v1);
    } else if (warp == 1) {
      // lane l holds rows 63 - l and 31 - l: a scan up the lanes sums from the end
      float s0 = st.dt[63 - lane] * ah * LOG2E, s1 = st.dt[31 - lane] * ah * LOG2E;
      s0 = warp_scan_up(s0, lane);
      s1 = warp_scan_up(s1, lane) + __shfl_sync(0xffffffffu, s0, 31);
      // exclusive suffix of row r is the inclusive suffix of row r + 1
      float e0 = __shfl_up_sync(0xffffffffu, s0, 1);
      float e1 = __shfl_up_sync(0xffffffffu, s1, 1);
      const float s0_last = __shfl_sync(0xffffffffu, s0, 31);
      if (lane == 0) {
        e0 = 0.f;
        e1 = s0_last;
      }
      sWt[63 - lane] = fast_exp2(e0) * st.dt[63 - lane];
      sWt[31 - lane] = fast_exp2(e1) * st.dt[31 - lane];
      if (lane == 31) *sTot = fast_exp2(s1);
    }
    __syncthreads();

    // C·hᵀ (rows ta, tb) and the fold h = exp(total) h + (w ⊙ x)ᵀ·B (state
    // columns of tiles 2w, 2w+1), four independent chains, over n and u
    float ys[2][4];
    {
      const float tot = *sTot;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ys[j][i] = 0.f;
          hacc[j][i] *= tot;
        }
#pragma unroll 2
      for (int kk = 0; kk < 8; ++kk) {
        const int k0 = 8 * kk + q;
        {
          const float af[4] = {st.c[ta * RS + k0], st.c[tb * RS + k0], st.c[ta * RS + k0 + 4],
                               st.c[tb * RS + k0 + 4]};
          uint32_t ahi[4], alo[4];
          split_tf32(af, ahi, alo);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float bf[2] = {sH[(pc + 8 * j + g) * RS + k0],
                                 sH[(pc + 8 * j + g) * RS + k0 + 4]};
            mma_split(ys[j], ahi, alo, bf);
          }
        }
        {
          const float w0 = sWt[k0], w1 = sWt[k0 + 4];
          const float* xc = st.x + pc + g;
          const float af[4] = {w0 * xc[k0 * XS], w0 * xc[k0 * XS + 8], w1 * xc[(k0 + 4) * XS],
                               w1 * xc[(k0 + 4) * XS + 8]};
          uint32_t ahi[4], alo[4];
          split_tf32(af, ahi, alo);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n0 = 8 * (2 * mw + j) + g;
            const float bf[2] = {st.b[k0 * RS + n0], st.b[(k0 + 4) * RS + n0]};
            mma_split(hacc[j], ahi, alo, bf);
          }
        }
      }
    }

    // y = G·x + exp(cum) (C·hᵀ)
    {
      float yi[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) yi[j][i] = 0.f;
      switch (mw) {
        case 0: gate_gx<2>(sc, yi, sCum, st.dt, st.x + pc, ta, g, q); break;
        case 1: gate_gx<4>(sc, yi, sCum, st.dt, st.x + pc, ta, g, q); break;
        case 2: gate_gx<6>(sc, yi, sCum, st.dt, st.x + pc, ta, g, q); break;
        default: gate_gx<8>(sc, yi, sCum, st.dt, st.x + pc, ta, g, q); break;
      }
      const float ea = sEc[ta], eb = sEc[tb];
#pragma unroll
      for (int pn = 0; pn < 2; ++pn) {
        const int p = p0 + pc + 8 * pn + 2 * q;
        if (p >= P) continue;
        if (t0 + ta < S) {
          float2 o = make_float2(fmaf(ea, ys[pn][0], yi[pn][0]), fmaf(ea, ys[pn][1], yi[pn][1]));
          *reinterpret_cast<float2*>(y + (((size_t)b * S + t0 + ta) * H + h) * P + p) = o;
        }
        if (t0 + tb < S) {
          float2 o = make_float2(fmaf(eb, ys[pn][2], yi[pn][2]), fmaf(eb, ys[pn][3], yi[pn][3]));
          *reinterpret_cast<float2*>(y + (((size_t)b * S + t0 + tb) * H + h) * P + p) = o;
        }
      }
    }
    __syncthreads();  // every read of the old state and of this buffer is done
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = 8 * (2 * mw + j) + 2 * q;
      sH[(pc + g) * RS + n] = hacc[j][0];
      sH[(pc + g) * RS + n + 1] = hacc[j][1];
      sH[(pc + g + 8) * RS + n] = hacc[j][2];
      sH[(pc + g + 8) * RS + n + 1] = hacc[j][3];
    }
  }
  cp_async_wait<0>();
}

}  // namespace
}  // namespace repro_torch

// All tensors f32 and contiguous on one device; P and N multiples of 4 up
// to 64; scratch holds B·ceil(S/64)·64·64 floats.  Launches two kernels
// (the shared C·Bᵀ, then the scan); returns cudaGetLastError() after them.
extern "C" int mamba2_ssd_fwd(const void* x, const void* dt, const void* a,
                              const void* bmat, const void* cmat, void* y, void* scratch,
                              int B, int S, int H, int P, int N, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > MAX_P || P % 4 || N <= 0 || N > MAX_N ||
      N % 4)
    return (int)cudaErrorInvalidValue;
  static int smem_done = 0;
  cudaError_t err = allow_smem(ssd_fwd_kernel, SMEM_BYTES, smem_done);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = (S + T - 1) / T;
  ssd_scores_kernel<<<dim3(ntiles, B), SCORE_THREADS, 0, st>>>(
      (const float*)bmat, (const float*)cmat, (float*)scratch, S, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_kernel<<<dim3(H, B, (P + PS - 1) / PS), THREADS, SMEM_BYTES, st>>>(
      (const float*)x, (const float*)dt, (const float*)a, (const float*)bmat,
      (const float*)cmat, (const float*)scratch, (float*)y, S, H, P, N);
  return (int)cudaGetLastError();
}

// Blocks of the scan kernel that fit on one SM at once (the occupancy API),
// its threads and shared memory per block.
extern "C" int mamba2_ssd_occupancy(int* blocks_per_sm, int* threads, int* smem_bytes) {
  using namespace repro_torch;
  static int smem_done = 0;
  cudaError_t err = allow_smem(ssd_fwd_kernel, SMEM_BYTES, smem_done);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ssd_fwd_kernel, THREADS,
                                                        SMEM_BYTES);
  *threads = THREADS;
  *smem_bytes = SMEM_BYTES;
  return (int)err;
}
