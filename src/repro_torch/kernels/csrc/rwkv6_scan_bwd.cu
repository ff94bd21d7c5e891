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
// static counter).  What held the first kernel (one block per (batch,
// head) walking all 2·S steps, 80 blocks for 132 SMs) to 0.08 of that was
// latency: each step waits on the last, and 52 SMs idled.  The design cuts
// the sequence into segments of SEG = 64 rows and works on them in
// parallel, four launches a call:
//
// 1. wkv_summary_kernel, two blocks per (segment, head, batch): each
//    segment's summaries from a zero start, its state
//    U = Σ_t (k_t ⊙ e^{suffix_t}) v_tᵀ (one block), its part of D entering
//    the previous segment W = Σ_t (r_t ⊙ e^{prefix_t}) dy_tᵀ and its total
//    decay e^{Σ logw} per key row (the other).  suffix and prefix are the
//    exclusive sums of logw from the segment's end and start, summed
//    directly, a thread per (row, quarter of the segment) (never a
//    difference of two prefix sums, never a positive exponent: logw = -25
//    stays finite).  U and W are products over the segment's rows on the
//    tensor cores in split TF32 (hopper.cuh's gram64_acc; one TF32 pass
//    misses the scans' 2e-4 by 20-60×).
// 2. wkv_carry_kernel, a thread per (batch, head, state entry): the state
//    into each segment and D at each segment's last row, walking the
//    segments in order, in place (common.cuh's carry_entry; no atomics).
// 3. wkv_segment_kernel, a block per (segment, head, batch): the step
//    recurrence inside the segment from those, as the first kernel did over
//    the whole sequence: S forwards (dr^s, kept in shared memory for the
//    segment), then D backwards (dk, dv, dr, dlogw's reverse sum inside the
//    segment in f64, du's partial).  Each exponent is one step's logw.
// 4. wkv_finish_kernel: dlogw's offsets, each segment's sum of the later
//    segments' totals (f64, from the last segment), added in f64 to its
//    rows' segment-local sums (which the segment kernel leaves in scratch
//    as f64, so dlogw is rounded to f32 once); du summed over batch and
//    segments in order.
//
// At rwkv6-3b's training shape that is 1280 segment blocks of 2 × 64
// steps, two to an SM, where the first kernel had 80 of 2 × 1024, and 640
// at a rank's 20 heads.  Scratch: U and W, 2·B·H·nseg·64² floats (41.9 MB
// at the training shape, 21.0 MB at a rank's), dlogw's segment-local sums,
// B·S·H·64 doubles (41.9 / 21.0 MB), the decays and two f64 values per
// (batch, head, segment, row).  What bounds it now: the
// segment kernel's steps, each touching the whole state in f32 on the CUDA
// cores (FMAs, shuffles and shared-memory loads, at two blocks an SM: 128
// registers a thread), and the summaries' and the carry's traffic (the
// inputs read once more, the summaries written, rewritten and read).
//
// The segment kernel: 256 threads, the whole (64×64) state in registers,
// 4 rows × 4 columns a thread (zero-padded past K); inputs staged TT = 16
// steps at a time by cp.async into the second of two buffers while the
// first computes (2 × 4 tiles a segment: forwards, then backwards), each
// decay exponentiated once as it lands; f32 FMAs in the steps; row sums
// (S dy, D v) by a transposing shuffle reduction over the 16 lanes that
// share a row group, column sums (Dᵀ k) over the half-warps by shuffle and
// over the 8 warps through shared memory once a tile.  Each tile's tails
// run on all 256 threads: a thread per (row, quarter of the tile), the
// quarters' f64 totals exchanged through shared memory and summed in a
// fixed order, so two calls on the same inputs give the same bits.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int KW = 64;                 // the state's rows and columns (K <= 64, zero-padded)
constexpr int SEG = 64;                // rows a segment
constexpr int TT = 16;                 // steps staged per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QUARTERS = THREADS / KW;   // tail threads per row
constexpr int STATE = KW * KW;

// summary kernel: three tiles of SEG rows of stride LS (k, v, logw or r,
// dy, logw); the quarters' decay sums
constexpr int LS = KW + 8;
constexpr int QROWS = SEG / QUARTERS;
constexpr int SUM_SMEM_BYTES = (3 * SEG * LS + QUARTERS * KW) * 4;

// segment kernel, in floats: two stage buffers (r, k, w, v, dy: TT × KW
// each), dr^s of the segment (SEG × KW), the row sums (TT × KW), the
// column partials (TT × WARPS × KW), u, v·dy and Σ r u k a step; then the
// quarters' f64 partials (QUARTERS × KW doubles)
constexpr int ST_R = 0, ST_K = TT * KW, ST_W = 2 * TT * KW, ST_V = 3 * TT * KW,
              ST_DY = 4 * TT * KW, STAGE = 5 * TT * KW;
constexpr int OFF_DRS = 2 * STAGE;
constexpr int OFF_ROW = OFF_DRS + SEG * KW;
constexpr int OFF_COL = OFF_ROW + TT * KW;
constexpr int OFF_U = OFF_COL + TT * WARPS * KW;
constexpr int OFF_VDY = OFF_U + KW;
constexpr int OFF_RUK = OFF_VDY + TT;
constexpr int OFF_Q = OFF_RUK + TT;                   // even: doubles 8-byte aligned
constexpr int SMEM_BYTES = OFF_Q * 4 + QUARTERS * KW * 8;

// the scratch a call needs, in bytes, with its parts' offsets
struct Scratch {
  size_t ustate, wgrad, dec, tot, dup, loc, bytes;
};
__host__ inline Scratch scratch_layout(int B, int S, int H) {
  const size_t segs = (size_t)B * H * ((S + SEG - 1) / SEG);
  Scratch s;
  s.tot = 0;                                         // f64: each segment's dlogw total
  s.dup = s.tot + segs * KW * 8;                     // f64: du's partial
  s.loc = s.dup + segs * KW * 8;                     // f64: dlogw inside its segment (B,S,H,KW)
  s.ustate = s.loc + (size_t)B * S * H * KW * 8;     // f32: U, then the state entering
  s.wgrad = s.ustate + segs * STATE * 4;             // f32: W, then D at the last row
  s.dec = s.wgrad + segs * STATE * 4;                // f32: e^{total}
  s.bytes = s.dec + segs * KW * 4;
  return s;
}

// Block (2j + which, h, b): segment j's U (which 0: k ⊙ e^{suffix} and v)
// or W (which 1: r ⊙ e^{prefix} and dy, and the segment's total decay), so
// that each block stages three tiles, not five.
__global__ void __launch_bounds__(THREADS, 3)
wkv_summary_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ dy, float* __restrict__ ustate,
                   float* __restrict__ wgrad, float* __restrict__ dec, int S, int H, int K) {
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                 // k, then k ⊙ e^{suffix}; or r, then r ⊙ e^{prefix}
  float* sB = sA + SEG * LS;        // v or dy
  float* sW = sB + SEG * LS;        // logw
  float* sQs = sW + SEG * LS;
  const int j = blockIdx.x >> 1, which = blockIdx.x & 1, h = blockIdx.y, b = blockIdx.z;
  const int nseg = gridDim.x >> 1;
  const int tid = threadIdx.x;
  const int n = min(SEG, S - j * SEG);
  const size_t step = (size_t)H * K;
  const size_t base = (((size_t)b * S + (size_t)j * SEG) * H + h) * K;
  stage_rows<KW>(sA, LS, (which ? r : k) + base, step, SEG, n, K, THREADS);
  stage_rows<KW>(sB, LS, (which ? dy : v) + base, step, SEG, n, K, THREADS);
  stage_rows<KW>(sW, LS, logw + base, step, SEG, n, K, THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const size_t seg = ((size_t)b * H + h) * nseg + j;
  // decay sums, a thread per (key row, quarter of the segment's rows): the
  // quarters' totals, then each row's exclusive prefix (the earlier
  // quarters' totals, then its own rows forwards) or exclusive suffix (the
  // later quarters', then its rows backwards), each a direct sum of logw;
  // the tile scaled by its exponential in place
  const int ci = tid % KW, cq = tid / KW;
  const int r0 = cq * QROWS, r1 = min(n, r0 + QROWS);
  float qsum = 0.f;
  for (int t = r0; t < r1; ++t) qsum += sW[t * LS + ci];
  sQs[cq * KW + ci] = qsum;
  __syncthreads();
  float e = 0.f;
  if (which) {
    for (int q = 0; q < cq; ++q) e += sQs[q * KW + ci];
    for (int t = r0; t < r1; ++t) {
      const float x = sW[t * LS + ci];
      sA[t * LS + ci] *= expf(e);
      e += x;
    }
    if (cq == QUARTERS - 1) dec[seg * KW + ci] = expf(e);   // the segment's total
  } else {
    for (int q = QUARTERS - 1; q > cq; --q) e += sQs[q * KW + ci];
    for (int t = r1 - 1; t >= r0; --t) {
      sA[t * LS + ci] *= expf(e);
      e += sW[t * LS + ci];
    }
  }
  __syncthreads();
  float acc[4][3][4] = {};
  gram64_acc(acc, sA, sB, LS, (n + 7) & ~7);   // rows past n are zeros
  gram64_store(acc, (which ? wgrad : ustate) + seg * STATE);
}

__global__ void wkv_carry_kernel(float* __restrict__ ustate, float* __restrict__ wgrad,
                                 const float* __restrict__ dec, int nseg, int BH) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)BH * STATE) return;
  const size_t bh = idx / STATE;
  const int e = (int)(idx % STATE);
  const size_t off = bh * nseg * STATE + e;
  carry_entry(ustate + off, wgrad + off, dec + bh * nseg * KW + e / KW, nseg, STATE, KW);
}

// One block per (segment, head, batch).  Thread map: warp w, lane l; row
// group rg = 2w + l/16 (rows 4rg..4rg+3 of the state), column group
// cg = l%16 (columns 4cg..4cg+3).
__global__ void __launch_bounds__(THREADS, 2)
wkv_segment_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ u, const float* __restrict__ dy,
                   const float* __restrict__ s_in, const float* __restrict__ dout,
                   float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                   float* __restrict__ dlogw, double* __restrict__ loc,
                   double* __restrict__ tot, double* __restrict__ dup, int S, int H, int K) {
  extern __shared__ __align__(16) float smem[];
  float* sDRS = smem + OFF_DRS;
  float* sRow = smem + OFF_ROW;
  float* sCol = smem + OFF_COL;
  float* sU = smem + OFF_U;
  float* sVdy = smem + OFF_VDY;
  float* sRuk = smem + OFF_RUK;
  double* sQ = reinterpret_cast<double*>(smem + OFF_Q);

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nseg = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 15;
  const int i0 = 4 * (2 * warp + (lane >> 4)), j0 = 4 * cg;
  // the row this lane's row sum lands on, written by the lanes cg < 4
  const int row_of = i0 + 2 * (cg & 1) + ((cg >> 1) & 1);
  // the tails' row and quarter of the tile
  const int ti = tid % KW, tq = tid / KW;
  const int n = min(SEG, S - j * SEG), ntiles = (n + TT - 1) / TT;
  const size_t step = (size_t)H * K;
  const size_t base = (((size_t)b * S + (size_t)j * SEG) * H + h) * K;   // (b, jSEG, h, 0)
  const size_t lbase = (((size_t)b * S + (size_t)j * SEG) * H + h) * KW;  // the same in loc
  const size_t seg = ((size_t)b * H + h) * nseg + j;
  if (tid < KW) sU[tid] = tid < K ? u[h * K + tid] : 0.f;

  // item it < ntiles: tile it forwards; then tile 2·ntiles − 1 − it backwards
  auto tile_of = [&](int it) { return it < ntiles ? it : 2 * ntiles - 1 - it; };
  auto load = [&](int it) {
    float* buf = smem + (it & 1) * STAGE;
    const int tx = tile_of(it);
    const size_t off = base + (size_t)tx * TT * step;
    const int valid = min(TT, n - tx * TT);
    if (it >= ntiles) stage_rows<KW>(buf + ST_R, KW, r + off, step, TT, valid, K, THREADS);
    stage_rows<KW>(buf + ST_K, KW, k + off, step, TT, valid, K, THREADS);
    stage_rows<KW>(buf + ST_W, KW, logw + off, step, TT, valid, K, THREADS);
    stage_rows<KW>(buf + ST_V, KW, v + off, step, TT, valid, K, THREADS);
    stage_rows<KW>(buf + ST_DY, KW, dy + off, step, TT, valid, K, THREADS);
    cp_async_commit();
  };

  // the pipeline: item `it`'s tile landed (and the next one's load in
  // flight), its decays exponentiated once, and for the backward items
  // each step's v·dy and Σ r u k, a warp a step
  auto prepare = [&](int it) -> float* {
    if (it + 1 < 2 * ntiles)
      load(it + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // this tile landed
    float* buf = smem + (it & 1) * STAGE;
    for (int idx = tid; idx < TT * KW; idx += THREADS) buf[ST_W + idx] = expf(buf[ST_W + idx]);
    if (it >= ntiles) {
      const int nt = min(TT, n - tile_of(it) * TT);
      const float *sR = buf + ST_R, *sK = buf + ST_K, *sV = buf + ST_V, *sDY = buf + ST_DY;
      for (int t = warp; t < nt; t += WARPS) {
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
    }
    __syncthreads();   // the decays are in place
    return buf;
  };
  load(0);

  // ---- forwards from the state entering the segment: dr^s_t = S_{t-1} dy_t
  // into sDRS, then S's update
  {
    float st[4][4];
    const float* s0 = s_in + seg * STATE;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 x = *reinterpret_cast<const float4*>(s0 + (i0 + a) * KW + j0);
      st[a][0] = x.x, st[a][1] = x.y, st[a][2] = x.z, st[a][3] = x.w;
    }
    for (int it = 0; it < ntiles; ++it) {
      const float* buf = prepare(it);
      const float *sK = buf + ST_K, *sW = buf + ST_W, *sV = buf + ST_V, *sDY = buf + ST_DY;
      const int t0 = it * TT, nt = min(TT, n - t0);
#pragma unroll 4
      for (int t = 0; t < nt; ++t) {
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
        if (cg < 4) sDRS[(t0 + t) * KW + row_of] = rs;
        const float4 k4 = ld4(sK + t * KW + i0), w4 = ld4(sW + t * KW + i0);
        const float4 v4 = ld4(sV + t * KW + j0);
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w}, ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) st[a][c] = fmaf(ww[a], st[a][c], kk[a] * vv[c]);
      }
      __syncthreads();   // every read of this buffer is done
    }
  }

  // ---- backwards from D at the segment's last row: dk^s = D v (rows),
  // dv^s = Dᵀ k (columns), then D's update; the tails
  double acc = 0.0;      // row ti: Σ of the later tiles' r dr^s − k dk^s in the segment
  double du_acc = 0.0;   // row ti, this thread's steps: Σ r k (v·dy)
  {
    float dd[4][4];
    const float* d0 = dout + seg * STATE;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 x = *reinterpret_cast<const float4*>(d0 + (i0 + a) * KW + j0);
      dd[a][0] = x.x, dd[a][1] = x.y, dd[a][2] = x.z, dd[a][3] = x.w;
    }
    for (int it = ntiles; it < 2 * ntiles; ++it) {
      const float* buf = prepare(it);
      const float *sR = buf + ST_R, *sK = buf + ST_K, *sW = buf + ST_W, *sV = buf + ST_V,
                  *sDY = buf + ST_DY;
      const int t0 = tile_of(it) * TT, nt = min(TT, n - t0);
#pragma unroll 4
      for (int t = nt - 1; t >= 0; --t) {
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
      for (int idx = tid; idx < nt * KW; idx += THREADS) {
        const int t = idx / KW, c = idx % KW;
        const float* col = sCol + t * WARPS * KW + c;
        float s = col[0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += col[w * KW];
        if (c < K) dv[base + (size_t)(t0 + t) * step + c] = fmaf(sRuk[t], sDY[idx], s);
      }
      // row ti, steps q0..q1-1 of the tile: this quarter's Σ (r dr^s − k dk^s) in f64
      const int q0 = tq * (TT / QUARTERS), q1 = min(q0 + TT / QUARTERS, nt);
      double part = 0.0;
      for (int t = q1 - 1; t >= q0; --t) {
        const int o = t * KW + ti;
        part += (double)sR[o] * sDRS[(t0 + t) * KW + ti] - (double)sK[o] * sRow[o];
      }
      sQ[tq * KW + ti] = part;
      __syncthreads();
      // dlogw (the reverse sum inside the segment), dk, dr and du's partial
      double after = acc;
      for (int q = QUARTERS - 1; q > tq; --q) after += sQ[q * KW + ti];
      const float ui = sU[ti];
      for (int t = q1 - 1; t >= q0; --t) {
        const int o = t * KW + ti;
        const float dks = sRow[o], drs = sDRS[(t0 + t) * KW + ti], rt = sR[o], kt = sK[o];
        const float vdy = sVdy[t];
        const double kd = (double)kt * dks;
        if (ti < K) {
          const size_t off = base + (size_t)(t0 + t) * step + ti;
          // the last segment's dlogw has no offset: rounded here; the
          // others' f64 sums wait for theirs in loc
          if (j == nseg - 1)
            dlogw[off] = (float)(after - kd);
          else
            loc[lbase + (size_t)(t0 + t) * H * KW + ti] = after - kd;
          dk[off] = fmaf(ui * rt, vdy, dks);
          dr[off] = fmaf(ui * kt, vdy, drs);
        }
        after += (double)rt * drs - kd;
        du_acc += (double)rt * kt * vdy;
      }
      for (int q = QUARTERS - 1; q >= 0; --q) acc += sQ[q * KW + ti];
      __syncthreads();   // every read of this buffer, the row sums and partials is done
    }
  }
  cp_async_wait<0>();
  // the segment's dlogw total and du's partial (the quarters in order)
  sQ[tq * KW + ti] = du_acc;
  __syncthreads();
  if (tid < KW) {
    double s = 0.0;
    for (int q = 0; q < QUARTERS; ++q) s += sQ[q * KW + tid];
    dup[seg * KW + tid] = s;
    tot[seg * KW + tid] = acc;
  }
}

// dlogw = loc + Σ_{j' > j} tot[j'] (f64, from the last segment), rounded
// once, on segment j's rows (the last segment's the segment kernel wrote);
// du = Σ_{b, j} du's partials, in order.  One block per (segment, head,
// batch).
__global__ void wkv_finish_kernel(float* __restrict__ dlogw, float* __restrict__ du,
                                  const double* __restrict__ loc,
                                  const double* __restrict__ tot,
                                  const double* __restrict__ dup, int B, int S, int H, int K) {
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nseg = gridDim.x;
  const int tid = threadIdx.x, i = tid % KW;
  if (i >= K) return;
  if (j < nseg - 1) {
    double off = 0.0;
    for (int jj = nseg - 1; jj > j; --jj) off += tot[(((size_t)b * H + h) * nseg + jj) * KW + i];
    const int n = min(SEG, S - j * SEG);
    const size_t step = (size_t)H * K;
    float* p = dlogw + (((size_t)b * S + (size_t)j * SEG) * H + h) * K + i;
    const double* q = loc + (((size_t)b * S + (size_t)j * SEG) * H + h) * KW + i;
    // this thread's rows, every QUARTERS-th: all loads, then all stores
    double x[SEG / QUARTERS];
#pragma unroll
    for (int a = 0; a < SEG / QUARTERS; ++a) {
      const int t = tid / KW + a * QUARTERS;
      x[a] = t < n ? q[(size_t)t * H * KW] : 0.0;
    }
#pragma unroll
    for (int a = 0; a < SEG / QUARTERS; ++a) {
      const int t = tid / KW + a * QUARTERS;
      if (t < n) p[t * step] = (float)(x[a] + off);
    }
  }
  if (j == 0 && b == 0 && tid < KW) {
    double s = 0.0;
    for (int bb = 0; bb < B; ++bb)
      for (int jj = 0; jj < nseg; ++jj) s += dup[(((size_t)bb * H + h) * nseg + jj) * KW + i];
    du[h * K + i] = (float)s;
  }
}

}  // namespace
}  // namespace repro_torch

// The scratch rwkv6_wkv_bwd needs, in bytes.
extern "C" long long rwkv6_wkv_bwd_scratch(int B, int S, int H) {
  return (long long)repro_torch::scratch_layout(B, S, H).bytes;
}

// All tensors f32 and contiguous on one device; K <= 64; scratch holds
// rwkv6_wkv_bwd_scratch(B, S, H) bytes, 16-byte aligned.  Launches four
// kernels (the segments' summaries, the carry, the segments, dlogw's
// offsets and du); returns cudaGetLastError() after each.
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v, const void* logw,
                             const void* u, const void* dy, void* dr, void* dk, void* dv,
                             void* dlogw, void* du, void* scratch, int B, int S, int H, int K,
                             void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || K > KW) return (int)cudaErrorInvalidValue;
  static int sum_done = 0, seg_done = 0;
  cudaError_t err = allow_smem(wkv_summary_kernel, SUM_SMEM_BYTES, sum_done);
  if (err == cudaSuccess) err = allow_smem(wkv_segment_kernel, SMEM_BYTES, seg_done);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const Scratch lay = scratch_layout(B, S, H);
  char* base = (char*)scratch;
  double* tot = (double*)(base + lay.tot);
  double* dup = (double*)(base + lay.dup);
  double* loc = (double*)(base + lay.loc);
  float* ustate = (float*)(base + lay.ustate);
  float* wgrad = (float*)(base + lay.wgrad);
  float* dec = (float*)(base + lay.dec);
  const int nseg = (S + SEG - 1) / SEG;
  const dim3 grid(nseg, H, B);
  wkv_summary_kernel<<<dim3(2 * nseg, H, B), THREADS, SUM_SMEM_BYTES, st>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)logw, (const float*)dy,
      ustate, wgrad, dec, S, H, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t entries = (size_t)B * H * STATE;
  wkv_carry_kernel<<<(unsigned)((entries + 255) / 256), 256, 0, st>>>(ustate, wgrad, dec, nseg,
                                                                       B * H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv_segment_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)logw, (const float*)u,
      (const float*)dy, ustate, wgrad, (float*)dr, (float*)dk, (float*)dv, (float*)dlogw, loc,
      tot, dup, S, H, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv_finish_kernel<<<grid, THREADS, 0, st>>>((float*)dlogw, (float*)du, loc, tot, dup, B, S, H,
                                              K);
  return (int)cudaGetLastError();
}

// Blocks of the segment kernel that fit on one SM at once (the occupancy
// API), its threads and shared memory per block, and the segment length.
extern "C" int rwkv6_wkv_bwd_occupancy(int* blocks_per_sm, int* threads, int* smem_bytes,
                                       int* segment) {
  using namespace repro_torch;
  static int smem_done = 0;
  cudaError_t err = allow_smem(wkv_segment_kernel, SMEM_BYTES, smem_done);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, wkv_segment_kernel,
                                                        THREADS, SMEM_BYTES);
  *threads = THREADS;
  *smem_bytes = SMEM_BYTES;
  *segment = SEG;
  return (int)err;
}
