// RWKV6 WKV scan backward for Hopper (sm_90a), from a zero state:
// r, k, v, logw (B,S,H,K) f32 with logw <= 0, bonus u (H,K) f32, and dy, the
// gradient of y (B,S,H,K) f32 → dr, dk, dv, dlogw (B,S,H,K) f32 and du (H,K).
//
// Forward:  y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ),  S_t = diag(w_t) S_{t-1} + k_t v_tᵀ,
//           w = exp(logw), S_{-1} = 0, S a (K×K) state: rows i (key), columns j (value).
//
// Replaces no TPU kernel: the reference has no Pallas backward for the scan;
// jax.value_and_grad differentiates its jnp chunked form,
// repro/models/rwkv6.py::_wkv_chunked.  The gradient of the chunked form is
// that of the recurrence (the chunk changes only the rounding), so this
// kernel computes the recurrence's gradient and takes no chunk: the wrapper
// checks the reference's grad_chunk and passes nothing.  With D_t = ∂L/∂S_t,
// carried backwards by D_{t-1} = diag(w_t) D_t + r_t dy_tᵀ (D_{S-1} = 0):
//
//   dr^s_t = S_{t-1} dy_t          dk^s_t = D_t v_t          dv^s_t = D_tᵀ k_t
//   dr_t = dr^s_t + u ⊙ k_t (v_t·dy_t)      dk_t = dk^s_t + u ⊙ r_t (v_t·dy_t)
//   dv_t = dv^s_t + (Σ_i r_t u k_t) dy_t    du = Σ_{b,t} r_t ⊙ k_t (v_t·dy_t)
//   dlogw_s = Σ_{t>s} r_t ⊙ dr^s_t − Σ_{t≥s} k_t ⊙ dk^s_t
//
// The last is a reverse sum over the sequence (⟨D_s, S_s⟩ row by row
// telescopes), so dlogw needs no pass of its own over the state.
//
// What bounds it on the H100: per (b, s, h) it reads 5·K floats and writes
// 4·K; the recurrence needs ~10·K² flops a position (S's update, S·dy, D's
// update, D·v, Dᵀ·k): at rwkv6-3b's training shape (2, 1024, 40, 64) 189 MB
// (0.056 ms) against 3.4 GFLOP (0.020 ms in split TF32), so the bytes bound
// it (chip_smoke.py::scan_grad_work; kernels/cost.py declares the chunked
// form's f32 operations, the work the reference's gradient does, for the
// static counter).  This first kernel is simple and right, in f32 on the
// CUDA cores; it is latency-bound, not at either bound:
//
// - One block per (batch, head), 256 threads, the whole (64×64) state in
//   registers, 4 rows × 4 columns a thread (zero-padded past K).  The block
//   walks the sequence forward recomputing the states (pass 1: dr^s, written
//   to dr), then backwards carrying D (pass 2), so no state goes to memory
//   and there is no scratch but du's partials.  Every exponent is one step's
//   logw ≤ 0 (w = exp(logw) ≤ 1, taken once per element as it is staged):
//   no positive exponent, no difference of prefix sums, so logw = -25 stays
//   finite (w underflows towards 0, as the recurrence's does).
// - f32 FMAs throughout (a TF32 product misses the scans' 2e-4 by 20-60×);
//   the reverse sum for dlogw and du's sum over the sequence in f64, one
//   thread a row.  No atomics: du's partials per batch go to scratch and a
//   second launch sums them over the batch in order, so two calls on the
//   same inputs give the same bits.
// - Row sums (S dy, D v) by a transposing shuffle reduction over the 16
//   lanes that share a row group (5 shuffles for 4 rows); column sums (Dᵀ k)
//   over the two half-warps by shuffle, then over the 8 warps through shared
//   memory once a tile, with nothing written but each warp's own slots in a
//   step, so a tile of TT steps needs two barriers, not two a step.
// - Inputs staged TT = 16 steps at a time into shared memory (zero-padded
//   channels, a ragged last tile masked by its step count).

#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int KW = 64;                 // the state's rows and columns (K <= 64, zero-padded)
constexpr int TT = 16;                 // steps staged per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// shared memory, in floats: r, k, w, v, dy, dr^s, the row sums (TT × KW
// each), the column partials (TT × WARPS × KW), u, v·dy and Σ r u k a step
constexpr int OFF_R = 0;
constexpr int OFF_K = OFF_R + TT * KW;
constexpr int OFF_W = OFF_K + TT * KW;
constexpr int OFF_V = OFF_W + TT * KW;
constexpr int OFF_DY = OFF_V + TT * KW;
constexpr int OFF_DR = OFF_DY + TT * KW;
constexpr int OFF_ROW = OFF_DR + TT * KW;
constexpr int OFF_COL = OFF_ROW + TT * KW;
constexpr int OFF_U = OFF_COL + TT * WARPS * KW;
constexpr int OFF_VDY = OFF_U + KW;
constexpr int OFF_RUK = OFF_VDY + TT;
constexpr int SMEM_BYTES = (OFF_RUK + TT) * 4;

// One block per (head, batch).  Thread map: warp w, lane l; row group
// rg = 2w + l/16 (rows 4rg..4rg+3 of the state), column group cg = l%16
// (columns 4cg..4cg+3).
__global__ void __launch_bounds__(THREADS, 2)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u, const float* __restrict__ dy,
               float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ dlogw, float* __restrict__ du_part, int S, int H, int K) {
  extern __shared__ float smem[];
  float* sR = smem + OFF_R;
  float* sK = smem + OFF_K;
  float* sW = smem + OFF_W;
  float* sV = smem + OFF_V;
  float* sDY = smem + OFF_DY;
  float* sDR = smem + OFF_DR;
  float* sRow = smem + OFF_ROW;
  float* sCol = smem + OFF_COL;
  float* sU = smem + OFF_U;
  float* sVdy = smem + OFF_VDY;
  float* sRuk = smem + OFF_RUK;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 15;
  const int i0 = 4 * (2 * warp + (lane >> 4)), j0 = 4 * cg;
  // the row this lane's row sum lands on, written by the lanes cg < 4
  const int row_of = i0 + 2 * (cg & 1) + ((cg >> 1) & 1);
  const size_t step = (size_t)H * K;                       // between consecutive t
  const size_t base = ((size_t)b * S * H + h) * K;         // (b, 0, h, 0)
  if (tid < KW) sU[tid] = tid < K ? u[h * K + tid] : 0.f;

  // ---- pass 1: the states forward; dr^s_t = S_{t-1} dy_t into dr
  float st[4][4] = {};
  for (int t0 = 0; t0 < S; t0 += TT) {
    const int n = min(TT, S - t0);
    __syncthreads();  // the previous tile's reads of shared memory are done
    for (int idx = tid; idx < TT * KW; idx += THREADS) {
      const int t = idx / KW, c = idx % KW;
      const bool ok = t < n && c < K;
      const size_t off = base + (size_t)(t0 + t) * step + c;
      sK[idx] = ok ? k[off] : 0.f;
      sW[idx] = ok ? expf(logw[off]) : 1.f;
      sV[idx] = ok ? v[off] : 0.f;
      sDY[idx] = ok ? dy[off] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float4 d4 = ld4(sDY + t * KW + j0);
      const float d[4] = {d4.x, d4.y, d4.z, d4.w};
      float part[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float s = st[a][0] * d[0];
#pragma unroll
        for (int c = 1; c < 4; ++c) s = fmaf(st[a][c], d[c], s);
        part[a] = s;
      }
      const float rs = row_sum16(part, lane);
      if (cg < 4) sRow[t * KW + row_of] = rs;
      const float4 k4 = ld4(sK + t * KW + i0), w4 = ld4(sW + t * KW + i0);
      const float4 v4 = ld4(sV + t * KW + j0);
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w}, ww[4] = {w4.x, w4.y, w4.z, w4.w};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[a][c] = fmaf(ww[a], st[a][c], kk[a] * vv[c]);
    }
    __syncthreads();
    for (int idx = tid; idx < n * KW; idx += THREADS) {
      const int t = idx / KW, c = idx % KW;
      if (c < K) dr[base + (size_t)(t0 + t) * step + c] = sRow[idx];
    }
  }

  // ---- pass 2: D backwards; dk, dv, dlogw, dr, du's partial
  float dd[4][4] = {};
  double acc = 0.0;      // row tid: Σ_{t > current} (r dr^s − k dk^s)
  double du_acc = 0.0;   // row tid: Σ_t r k (v·dy)
  for (int t0 = ((S - 1) / TT) * TT; t0 >= 0; t0 -= TT) {
    const int n = min(TT, S - t0);
    __syncthreads();
    for (int idx = tid; idx < TT * KW; idx += THREADS) {
      const int t = idx / KW, c = idx % KW;
      const bool ok = t < n && c < K;
      const size_t off = base + (size_t)(t0 + t) * step + c;
      sR[idx] = ok ? r[off] : 0.f;
      sK[idx] = ok ? k[off] : 0.f;
      sW[idx] = ok ? expf(logw[off]) : 1.f;
      sV[idx] = ok ? v[off] : 0.f;
      sDY[idx] = ok ? dy[off] : 0.f;
      sDR[idx] = ok ? dr[off] : 0.f;  // pass 1's dr^s, written by this block
    }
    __syncthreads();
    // v·dy and Σ r u k of each step, a warp a step (read after the barrier below)
    for (int t = warp; t < n; t += WARPS) {
      const int o = t * KW + lane;
      float vd = fmaf(sV[o], sDY[o], sV[o + 32] * sDY[o + 32]);
      float ruk = fmaf(sR[o] * sU[lane], sK[o], sR[o + 32] * sU[lane + 32] * sK[o + 32]);
      vd = group_sum<32>(vd);
      ruk = group_sum<32>(ruk);
      if (lane == 0) {
        sVdy[t] = vd;
        sRuk[t] = ruk;
      }
    }
#pragma unroll 4
    for (int t = n - 1; t >= 0; --t) {
      const float4 v4 = ld4(sV + t * KW + j0), y4 = ld4(sDY + t * KW + j0);
      const float4 k4 = ld4(sK + t * KW + i0), r4 = ld4(sR + t * KW + i0);
      const float4 w4 = ld4(sW + t * KW + i0);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w}, yy[4] = {y4.x, y4.y, y4.z, y4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w}, rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
      float rowp[4], colp[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float s = dd[a][0] * vv[0];
#pragma unroll
        for (int c = 1; c < 4; ++c) s = fmaf(dd[a][c], vv[c], s);
        rowp[a] = s;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = dd[0][c] * kk[0];
#pragma unroll
        for (int a = 1; a < 4; ++a) s = fmaf(dd[a][c], kk[a], s);
        colp[c] = s;
      }
      const float rs = row_sum16(rowp, lane);
      if (cg < 4) sRow[t * KW + row_of] = rs;
      const float2 cs = col_sum2(colp, lane);
      *reinterpret_cast<float2*>(sCol + (t * WARPS + warp) * KW + j0 + 2 * (lane >> 4)) = cs;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) dd[a][c] = fmaf(ww[a], dd[a][c], rr[a] * yy[c]);
    }
    __syncthreads();
    // dv_t: the warps' column partials, in order, and the bonus term
    for (int idx = tid; idx < n * KW; idx += THREADS) {
      const int t = idx / KW, c = idx % KW;
      const float* col = sCol + t * WARPS * KW + c;
      float s = col[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += col[w * KW];
      if (c < K) dv[base + (size_t)(t0 + t) * step + c] = fmaf(sRuk[t], sDY[idx], s);
    }
    // row tid: dk, dr, dlogw (the reverse sum, continued from the later tile), du
    if (tid < K) {
      const float ui = sU[tid];
      for (int t = n - 1; t >= 0; --t) {
        const int o = t * KW + tid;
        const size_t off = base + (size_t)(t0 + t) * step + tid;
        const float dks = sRow[o], drs = sDR[o], rt = sR[o], kt = sK[o], vdy = sVdy[t];
        const double kd = (double)kt * dks;
        dlogw[off] = (float)(acc - kd);
        acc += (double)rt * drs - kd;
        dk[off] = fmaf(ui * rt, vdy, dks);
        dr[off] = fmaf(ui * kt, vdy, drs);
        du_acc += (double)rt * kt * vdy;
      }
    }
  }
  if (tid < K) du_part[((size_t)b * H + h) * K + tid] = (float)du_acc;
}

// du = Σ_b du_part[b], in order of b.
__global__ void wkv_du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int B,
                              int HK) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HK) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[(size_t)b * HK + i];
  du[i] = s;
}

}  // namespace
}  // namespace repro_torch

// All tensors f32 and contiguous on one device; K <= 64; scratch holds
// B·H·K floats (du's partials).  Launches two kernels (the recurrence
// forward and back, then du's sum over the batch); returns
// cudaGetLastError() after them.
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v, const void* logw,
                             const void* u, const void* dy, void* dr, void* dk, void* dv,
                             void* dlogw, void* du, void* scratch, int B, int S, int H, int K,
                             void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || K > KW) return (int)cudaErrorInvalidValue;
  static int smem_done = 0;
  cudaError_t err = allow_smem(wkv_bwd_kernel, SMEM_BYTES, smem_done);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  wkv_bwd_kernel<<<dim3(H, B), THREADS, SMEM_BYTES, st>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)logw, (const float*)u,
      (const float*)dy, (float*)dr, (float*)dk, (float*)dv, (float*)dlogw, (float*)scratch, S,
      H, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int hk = H * K;
  wkv_du_kernel<<<(hk + 255) / 256, 256, 0, st>>>((const float*)scratch, (float*)du, B, hk);
  return (int)cudaGetLastError();
}
