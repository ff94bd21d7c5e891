// Mamba2 SSD scan backward for Hopper (sm_90a), from a zero state, one B/C
// group: x (B,S,H,P), dt (B,S,H), a (H,) < 0, B and C (B,S,N), and dy, the
// gradient of y (B,S,H,P), all f32 → dx (B,S,H,P), ddt (B,S,H), da (H,),
// dB and dC (B,S,N) f32.
//
// Forward:  h_t = α_t h_{t-1} + z_t ⊗ B_t (P×N per head),  y_t = h_t C_t,
//           α_t = exp(dt_t a),  z_t = dt_t x_t,  h_{-1} = 0  (y without the D-skip term).
//
// Replaces no TPU kernel: the reference has no Pallas backward for the scan;
// jax.value_and_grad differentiates its jnp chunked form,
// repro/models/mamba2.py::_ssd_chunked.  Its gradient is that of the
// recurrence (the chunk changes only the rounding; see mamba2_ssd.cu), so
// this kernel computes the recurrence's gradient and takes no chunk or
// head_block: the wrapper checks them as the reference does and passes
// neither.  With G_t = ∂L/∂h_t = dy_t ⊗ C_t + α_{t+1} G_{t+1}:
//
//   dz_t = G_t B_t,  dx_t = dt_t dz_t,  dC_t = Σ_h Σ_p dy_t[p] h_t[p,:],
//   dB_t = Σ_h Σ_p z_t[p] G_t[p,:],
//   dc_t = ⟨dy_t, y_t⟩ − ⟨dz_t, z_t⟩ per head, dl = its reverse cumulative sum
//   (∂L/∂(dt_t a) = α_t ⟨G_t, h_{t-1}⟩ telescopes to it),
//   ddt_t = a dl_t + ⟨dz_t, x_t⟩,  da = Σ_{b,t} dt_t dl_t.
//
// What bounds it on the H100: per (b, s, h) it reads 2·P + 1 floats (and
// 2·N per (b, s), shared by the heads) and writes P + 1; the recurrence
// needs ~10·P·N flops a position (h's update, dC's Σ_p dy h, G's update,
// G·B, dB's Σ_p z G; ⟨dy, y⟩ could come from dC, this kernel reads y out):
// at zamba2-2.7b's training shape (2, 1024, 80, 64, 64) 129 MB (0.039 ms)
// against 6.7 GFLOP (0.041 ms in split TF32), so the operations bound it,
// barely (chip_smoke.py::scan_grad_work; kernels/cost.py declares the
// chunked form's f32 operations, the work the reference's gradient does,
// for the static counter).  This first kernel is simple and right, in f32
// on the CUDA cores; it is latency-bound, not at either bound:
//
// - One block per (batch, head), 256 threads, the whole (64×64) state in
//   registers, 4 rows p × 4 columns n a thread (zero-padded past P and N).
//   The block walks the sequence forward recomputing h (pass 1: y for
//   ⟨dy, y⟩, and dC's partial), then backwards carrying G (pass 2: dz, dB's
//   partial, dx, ddt).  The only decay is one step's α = exp(dt a) ≤ 1,
//   taken once per step: no positive exponent and no difference of prefix
//   sums, so zamba2's initial dt·a ≈ -0.69 over any span stays finite.
// - f32 FMAs throughout (a TF32 product misses the scans' 2e-4 by ~60×);
//   dl's reverse sum and da's sum over the sequence in f64, one thread.
// - No atomics.  dB and dC sum over the heads, which are other blocks: each
//   block writes its (B,S,N) partial per head to scratch and a second launch
//   sums the heads in order (and da's partials over the batch), so two calls
//   on the same inputs give the same bits.
// - Row sums (h C, G B) by a transposing shuffle reduction over the 16
//   lanes that share a row group (5 shuffles for 4 rows); column sums over
//   the two half-warps by shuffle, then over the 8 warps through shared
//   memory once a tile, so a tile of TT steps needs two barriers, not two a
//   step.  Inputs staged TT = 16 steps at a time (a ragged last tile masked).

#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int DW = 64;                 // P and N (<= 64, zero-padded)
constexpr int TT = 16;                 // steps staged per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// shared memory, in floats: x, dy, B, C, the row sums (TT × DW each), the
// column partials (TT × WARPS × DW), and per step dt, α, ⟨dy, y⟩, ⟨dz, x⟩
constexpr int OFF_X = 0;
constexpr int OFF_DY = OFF_X + TT * DW;
constexpr int OFF_B = OFF_DY + TT * DW;
constexpr int OFF_C = OFF_B + TT * DW;
constexpr int OFF_ROW = OFF_C + TT * DW;
constexpr int OFF_COL = OFF_ROW + TT * DW;
constexpr int OFF_DT = OFF_COL + TT * WARPS * DW;
constexpr int OFF_AL = OFF_DT + TT;
constexpr int OFF_YDY = OFF_AL + TT;
constexpr int OFF_DZX = OFF_YDY + TT;
constexpr int SMEM_BYTES = (OFF_DZX + TT) * 4;

// Stages tile [t0, t0 + n): x, dy (P wide), B, C (N wide), dt and α.
__device__ __forceinline__ void stage(float* smem, const float* __restrict__ x,
                                      const float* __restrict__ dt,
                                      const float* __restrict__ bm, const float* __restrict__ cm,
                                      const float* __restrict__ dy, float ah, size_t xbase,
                                      size_t xstep, size_t dtbase, size_t nbase, int t0, int n,
                                      int H, int P, int N) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < TT * DW; idx += THREADS) {
    const int t = idx / DW, c = idx % DW;
    const bool okp = t < n && c < P, okn = t < n && c < N;
    const size_t xo = xbase + (size_t)(t0 + t) * xstep + c;
    const size_t no = nbase + (size_t)(t0 + t) * N + c;
    smem[OFF_X + idx] = okp ? x[xo] : 0.f;
    smem[OFF_DY + idx] = okp ? dy[xo] : 0.f;
    smem[OFF_B + idx] = okn ? bm[no] : 0.f;
    smem[OFF_C + idx] = okn ? cm[no] : 0.f;
  }
  if (tid < TT) {
    const float d = tid < n ? dt[dtbase + (size_t)(t0 + tid) * H] : 0.f;
    smem[OFF_DT + tid] = d;
    smem[OFF_AL + tid] = expf(d * ah);
  }
}

// One block per (head, batch).  Thread map: warp w, lane l; rows
// p = 4(2w + l/16).. of the state, columns n = 4(l%16)..
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ dy,
               float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ ydy,
               float* __restrict__ db_part, float* __restrict__ dc_part,
               float* __restrict__ da_part, int S, int H, int P, int N) {
  extern __shared__ float smem[];
  const float* sX = smem + OFF_X;
  const float* sDY = smem + OFF_DY;
  const float* sB = smem + OFF_B;
  const float* sC = smem + OFF_C;
  float* sRow = smem + OFF_ROW;
  float* sCol = smem + OFF_COL;
  const float* sDt = smem + OFF_DT;
  const float* sAl = smem + OFF_AL;
  float* sYdy = smem + OFF_YDY;
  float* sDzx = smem + OFF_DZX;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 15;
  const int p0 = 4 * (2 * warp + (lane >> 4)), n0 = 4 * cg;
  const int row_of = p0 + 2 * (cg & 1) + ((cg >> 1) & 1);
  const float ah = a[h];
  const size_t xstep = (size_t)H * P, xbase = ((size_t)b * S * H + h) * P;
  const size_t dtbase = (size_t)b * S * H + h;              // step H
  const size_t nbase = (size_t)b * S * N;                   // step N
  const size_t pstep = (size_t)H * N, pbase = ((size_t)b * S * H + h) * N;
  float* yd = ydy + ((size_t)b * H + h) * S;

  // ---- pass 1: h forward; y_t (for ⟨dy_t, y_t⟩) and dC's partial
  float hs[4][4] = {};
  for (int t0 = 0; t0 < S; t0 += TT) {
    const int n = min(TT, S - t0);
    __syncthreads();  // the previous tile's reads of shared memory are done
    stage(smem, x, dt, bm, cm, dy, ah, xbase, xstep, dtbase, nbase, t0, n, H, P, N);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float d = sDt[t], al = sAl[t];
      const float4 x4 = ld4(sX + t * DW + p0), y4 = ld4(sDY + t * DW + p0);
      const float4 b4 = ld4(sB + t * DW + n0), c4 = ld4(sC + t * DW + n0);
      const float zz[4] = {d * x4.x, d * x4.y, d * x4.z, d * x4.w};
      const float yy[4] = {y4.x, y4.y, y4.z, y4.w};
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w}, cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) hs[i][j] = fmaf(al, hs[i][j], zz[i] * bb[j]);
      float rowp[4], colp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = hs[i][0] * cc[0];
#pragma unroll
        for (int j = 1; j < 4; ++j) s = fmaf(hs[i][j], cc[j], s);
        rowp[i] = s;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = yy[0] * hs[0][j];
#pragma unroll
        for (int i = 1; i < 4; ++i) s = fmaf(yy[i], hs[i][j], s);
        colp[j] = s;
      }
      const float rs = row_sum16(rowp, lane);
      if (cg < 4) sRow[t * DW + row_of] = rs;
      const float2 cs = col_sum2(colp, lane);
      *reinterpret_cast<float2*>(sCol + (t * WARPS + warp) * DW + n0 + 2 * (lane >> 4)) = cs;
    }
    __syncthreads();
    for (int idx = tid; idx < n * DW; idx += THREADS) {
      const int t = idx / DW, c = idx % DW;
      const float* col = sCol + t * WARPS * DW + c;
      float s = col[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += col[w * DW];
      if (c < N) dc_part[pbase + (size_t)(t0 + t) * pstep + c] = s;
    }
    for (int t = warp; t < n; t += WARPS) {
      const int o = t * DW + lane;
      const float s = group_sum<32>(fmaf(sDY[o], sRow[o], sDY[o + 32] * sRow[o + 32]));
      if (lane == 0) yd[t0 + t] = s;
    }
  }

  // ---- pass 2: G backwards; dx, dB's partial, ddt, da's partial
  float g[4][4] = {};
  double dl = 0.0, da_acc = 0.0;   // thread 0
  for (int t0 = ((S - 1) / TT) * TT; t0 >= 0; t0 -= TT) {
    const int n = min(TT, S - t0);
    __syncthreads();
    stage(smem, x, dt, bm, cm, dy, ah, xbase, xstep, dtbase, nbase, t0, n, H, P, N);
    if (tid < n) sYdy[tid] = yd[t0 + tid];  // pass 1's, written by this block
    __syncthreads();
#pragma unroll 4
    for (int t = n - 1; t >= 0; --t) {
      const float d = sDt[t], al = sAl[t];
      const float4 x4 = ld4(sX + t * DW + p0), y4 = ld4(sDY + t * DW + p0);
      const float4 b4 = ld4(sB + t * DW + n0), c4 = ld4(sC + t * DW + n0);
      const float zz[4] = {d * x4.x, d * x4.y, d * x4.z, d * x4.w};
      const float yy[4] = {y4.x, y4.y, y4.z, y4.w};
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w}, cc[4] = {c4.x, c4.y, c4.z, c4.w};
      // g holds α_{t+1} G_{t+1}: G_t = dy_t ⊗ C_t + α_{t+1} G_{t+1}
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = fmaf(yy[i], cc[j], g[i][j]);
      float rowp[4], colp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = g[i][0] * bb[0];
#pragma unroll
        for (int j = 1; j < 4; ++j) s = fmaf(g[i][j], bb[j], s);
        rowp[i] = s;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = zz[0] * g[0][j];
#pragma unroll
        for (int i = 1; i < 4; ++i) s = fmaf(zz[i], g[i][j], s);
        colp[j] = s;
      }
      const float rs = row_sum16(rowp, lane);
      if (cg < 4) sRow[t * DW + row_of] = rs;
      const float2 cs = col_sum2(colp, lane);
      *reinterpret_cast<float2*>(sCol + (t * WARPS + warp) * DW + n0 + 2 * (lane >> 4)) = cs;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] *= al;
    }
    __syncthreads();
    for (int idx = tid; idx < n * DW; idx += THREADS) {
      const int t = idx / DW, c = idx % DW;
      const float* col = sCol + t * WARPS * DW + c;
      float s = col[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += col[w * DW];
      if (c < N) db_part[pbase + (size_t)(t0 + t) * pstep + c] = s;
    }
    // dx = dt dz and ⟨dz_t, x_t⟩, a warp a step
    for (int t = warp; t < n; t += WARPS) {
      const int o = t * DW + lane;
      const float d = sDt[t], z0 = sRow[o], z1 = sRow[o + 32];
      const size_t xo = xbase + (size_t)(t0 + t) * xstep + lane;
      if (lane < P) dx[xo] = d * z0;
      if (lane + 32 < P) dx[xo + 32] = d * z1;
      const float s = group_sum<32>(fmaf(z0, sX[o], z1 * sX[o + 32]));
      if (lane == 0) sDzx[t] = s;
    }
    __syncthreads();
    // dl: the reverse sum of dc_t = ⟨dy, y⟩ − dt ⟨dz, x⟩, continued from the later tile
    if (tid == 0) {
      for (int t = n - 1; t >= 0; --t) {
        const double dzx = sDzx[t], d = sDt[t];
        dl += (double)sYdy[t] - d * dzx;
        ddt[dtbase + (size_t)(t0 + t) * H] = (float)((double)ah * dl + dzx);
        da_acc += d * dl;
      }
    }
  }
  if (tid == 0) da_part[(size_t)b * H + h] = (float)da_acc;
}

// dB and dC: the heads' partials summed in order; da: the batch's.  One
// block per (b, t), a thread per state column n.
__global__ void ssd_bc_kernel(const float* __restrict__ db_part,
                              const float* __restrict__ dc_part,
                              const float* __restrict__ da_part, float* __restrict__ db,
                              float* __restrict__ dc, float* __restrict__ da, int B, int H,
                              int N) {
  const size_t row = blockIdx.x;   // b·S + t
  const int c = threadIdx.x;
  if (c < N) {
    const float* pb = db_part + row * H * N + c;
    const float* pc = dc_part + row * H * N + c;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += pb[(size_t)h * N];
      sc += pc[(size_t)h * N];
    }
    db[row * N + c] = sb;
    dc[row * N + c] = sc;
  }
  if (row == 0) {
    for (int h = c; h < H; h += blockDim.x) {
      float s = 0.f;
      for (int b = 0; b < B; ++b) s += da_part[(size_t)b * H + h];
      da[h] = s;
    }
  }
}

}  // namespace
}  // namespace repro_torch

// All tensors f32 and contiguous on one device; P, N <= 64; scratch holds
// B·H·S (⟨dy, y⟩ per step) + 2·B·S·H·N (dB's and dC's partials per head) +
// B·H (da's) floats.  Launches two kernels (the recurrence forward and back,
// then the sums over heads and batch); returns cudaGetLastError() after them.
extern "C" int mamba2_ssd_bwd(const void* x, const void* dt, const void* a, const void* bm,
                              const void* cm, const void* dy, void* dx, void* ddt, void* da,
                              void* db, void* dc, void* scratch, int B, int S, int H, int P,
                              int N, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || P > DW || N > DW)
    return (int)cudaErrorInvalidValue;
  static int smem_done = 0;
  cudaError_t err = allow_smem(ssd_bwd_kernel, SMEM_BYTES, smem_done);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  float* ydy = (float*)scratch;
  float* db_part = ydy + (size_t)B * H * S;
  float* dc_part = db_part + (size_t)B * S * H * N;
  float* da_part = dc_part + (size_t)B * S * H * N;
  ssd_bwd_kernel<<<dim3(H, B), THREADS, SMEM_BYTES, st>>>(
      (const float*)x, (const float*)dt, (const float*)a, (const float*)bm, (const float*)cm,
      (const float*)dy, (float*)dx, (float*)ddt, ydy, db_part, dc_part, da_part, S, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bc_kernel<<<B * S, DW, 0, st>>>(db_part, dc_part, da_part, (float*)db, (float*)dc,
                                      (float*)da, B, H, N);
  return (int)cudaGetLastError();
}
