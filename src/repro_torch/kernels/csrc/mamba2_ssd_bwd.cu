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
//   ddt_t = a dl_t + ⟨dz_t, x_t⟩,  da = Σ_{b,t} dt_t dl_t,
//
// and ⟨dy_t, y_t⟩ = ⟨C_t, Σ_p dy_t[p] h_t[p,:]⟩, dC's head term, so y is
// never formed.
//
// What bounds it on the H100: per (b, s, h) it reads 2·P + 1 floats (and
// 2·N per (b, s), shared by the heads) and writes P + 1; the recurrence
// needs ~10·P·N flops a position (h's update, dC's Σ_p dy h, G's update,
// G·B, dB's Σ_p z G): at zamba2-2.7b's training shape (2, 1024, 80, 64, 64)
// 129 MB (0.039 ms) against 6.7 GFLOP (0.041 ms in split TF32), so the
// operations bound it, barely (chip_smoke.py::scan_grad_work;
// kernels/cost.py declares the chunked form's f32 operations for the
// static counter).  What held the first kernel (one block per (batch,
// head) walking all 2·S steps; dB's and dC's partials per head, 83.9 MB,
// through memory) to 0.04 of that was latency, and at a rank's 5 heads
// ten blocks on 132 SMs.  The design cuts the sequence into segments of
// SEG = 128 rows and works on them in parallel, four launches a call:
//
// 1. ssd_summary_kernel, two blocks per (segment, head, batch): each
//    segment's summaries from a zero start, its state
//    U = Σ_t e^{suffix_t} z_t ⊗ B_t (one block), its part of G carried into
//    the previous segment V = Σ_t e^{prefix_t} dy_t ⊗ C_t and its total
//    decay e^{Σ dt a} (the other); suffix is the exclusive sum of dt·a from
//    the segment's end, prefix the inclusive one from its start, each a
//    direct sum (a lane's rows, then a shuffle scan over the lanes' totals;
//    never a difference of two prefix sums, never a positive exponent:
//    zamba2's dt·a ≈ -0.69 over 256 rows stays finite).  U and V are
//    products over the segment's rows, 64 at a time, on the tensor cores
//    in split TF32 (hopper.cuh's gram64_acc).
// 2. ssd_carry_kernel, a thread per (batch, head, state entry): h into
//    each segment and α G into each segment's last row, in place
//    (common.cuh's carry_entry; no atomics).
// 3. ssd_segment_kernel, a block per (head, segment, batch), in thread
//    block clusters of the heads of one group (g of them, the largest
//    divisor of H up to 8: 8 at zamba2-2.7b's 80 heads): the step
//    recurrence inside the segment from those, h forwards (dC's head term
//    and ⟨dy, y⟩), then G backwards (dz, dx, dB's head term, and dl's
//    reverse sum inside the segment in f64, on 16 lanes by shuffles).  A
//    block keeps its head's dC term for the segment in shared memory, and
//    after the forward pass the cluster sums it over its heads, in head
//    order, through distributed shared memory; then the same buffer holds
//    the dB term, summed so after the backward pass.  Only one partial per
//    group reaches memory: 2·B·S·(H/g)·N floats, 10.5 MB at the training
//    shape against the first kernel's 83.9 MB of partials per head.
// 4. ssd_finish_kernel: dl's offsets, each segment's sum of the later
//    segments' totals (f64, from the last segment), added to ddt as
//    a·offset in f64 (the segment kernel leaves each row's ddt without it
//    as f64 in scratch, so ddt is rounded to f32 once); da from each segment's Σ dt·dl and Σ dt; dB and dC summed
//    over the groups in order.
//
// At the training shape that is 1280 segment blocks of 2 × 128 steps, two
// to an SM, where the first kernel had 160 of 2 × 1024; at a rank's 5
// heads, 80 where it had 10.  Scratch: U and V, 2·B·H·nseg·64² floats
// (41.9 MB at the training shape, 0.32 of the least work's 129 MB of
// bytes; 21.0 MB at a rank's 40 heads, 2.6 MB at 5), the group partials,
// ddt's rows without their offsets, B·S·H doubles (1.3 MB), and a few
// values per (batch, head, segment).  What bounds it now: the
// segment kernel's steps, each touching the whole state in f32 on the CUDA
// cores, and the summaries' and the carry's traffic.
//
// The segment kernel: 256 threads, the whole (64×64) state in registers, 4
// rows p × 4 columns n a thread (zero-padded past P and N); inputs staged
// TT = 16 steps at a time by cp.async into the second of two buffers while
// the first computes, each step's α = exp(dt a) taken once as it lands;
// f32 FMAs in the steps; row sums (G B) by a transposing shuffle reduction
// over 16 lanes, column sums (dy h, z G) over the half-warps by shuffle and
// over the 8 warps through shared memory once a tile.  Every sum over
// blocks is taken by one thread in a fixed order, so two calls on the same
// inputs give the same bits.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {
namespace {

constexpr int DW = 64;                 // P and N (<= 64, zero-padded)
constexpr int SEG = 128;               // rows a segment
constexpr int TT = 16;                 // steps staged per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STATE = DW * DW;
constexpr int MAX_GROUP = 8;           // heads a cluster (the portable cluster size)

// summary kernel: two buffers of HROWS rows (stride LS) of x and B, or of
// dy and C; dt, and the rows' coefficients dt·e^{suffix} and e^{prefix}
constexpr int LS = DW + 8;
constexpr int HROWS = 64;
constexpr int SUM_SMEM_BYTES = (4 * HROWS * LS + 2 * SEG) * 4;

// segment kernel, in floats: two stage buffers (x, dy, B, C: TT × DW each;
// dt, α: TT each), the head's dC term, then its dB term, for the segment
// (SEG × DW), the row sums (TT × DW), the column partials (TT × WARPS ×
// DW), ⟨dy, y⟩ per row of the segment and ⟨dz, x⟩ per step of a tile
constexpr int ST_X = 0, ST_DY = TT * DW, ST_B = 2 * TT * DW, ST_C = 3 * TT * DW,
              ST_DT = 4 * TT * DW, ST_AL = ST_DT + TT, STAGE = ST_AL + TT;
constexpr int OFF_DBC = 2 * STAGE;
constexpr int OFF_ROW = OFF_DBC + SEG * DW;
constexpr int OFF_COL = OFF_ROW + TT * DW;
constexpr int OFF_YDY = OFF_COL + TT * WARPS * DW;
constexpr int OFF_DZX = OFF_YDY + SEG;
constexpr int SMEM_BYTES = (OFF_DZX + TT) * 4;

// heads a cluster: the largest divisor of H up to MAX_GROUP
__host__ inline int group_of(int H) {
  int g = MAX_GROUP < H ? MAX_GROUP : H;
  while (H % g) --g;
  return g;
}

// the scratch a call needs, in bytes, with its parts' offsets
struct Scratch {
  size_t tot, dap, dts, loc, ustate, gcarry, dec, part_db, part_dc, bytes;
};
__host__ inline Scratch scratch_layout(int B, int S, int H, int N) {
  const size_t segs = (size_t)B * H * ((S + SEG - 1) / SEG);
  const size_t parts = (size_t)B * S * (H / group_of(H)) * N;
  Scratch s;
  s.tot = 0;                                  // f64: each segment's Σ dc
  s.dap = s.tot + segs * 8;                   // f64: its Σ dt·dl (the segment's own dl)
  s.dts = s.dap + segs * 8;                   // f64: its Σ dt
  s.loc = s.dts + segs * 8;                   // f64: ddt without dl's offset (B,S,H)
  s.ustate = (s.loc + (size_t)B * S * H * 8 + 255) & ~(size_t)255;   // f32: U, then h entering
  s.gcarry = s.ustate + segs * STATE * 4;     // f32: V, then α G from the later segments
  s.dec = s.gcarry + segs * STATE * 4;        // f32: e^{total}
  s.part_db = s.dec + ((segs * 4 + 15) & ~(size_t)15);
  s.part_dc = s.part_db + parts * 4;
  s.bytes = s.part_dc + parts * 4;
  return s;
}

// Block (2j + which, h, b): segment j's U (which 0: dt·e^{suffix}·x and B)
// or V (which 1: e^{prefix}·dy and C, and the segment's total decay), its
// rows staged HROWS at a time into two buffers.
__global__ void __launch_bounds__(THREADS, 2)
ssd_summary_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const float* __restrict__ bm,
                   const float* __restrict__ cm, const float* __restrict__ dy,
                   float* __restrict__ ustate, float* __restrict__ gcarry,
                   float* __restrict__ dec, int S, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* sDt = smem + 4 * HROWS * LS;
  float* sCo = sDt + SEG;      // the rows' coefficients
  const int j = blockIdx.x >> 1, which = blockIdx.x & 1, h = blockIdx.y, b = blockIdx.z;
  const int nseg = gridDim.x >> 1;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n = min(SEG, S - j * SEG), nh = (n + HROWS - 1) / HROWS;
  const size_t t0 = (size_t)b * S + (size_t)j * SEG;   // (b, jSEG)
  const size_t xstep = (size_t)H * P;
  const size_t seg = ((size_t)b * H + h) * nseg + j;
  // stage s: rows [s·HROWS, ..) of x and B, or of dy and C
  auto stage = [&](int s) {
    float* buf = smem + (s & 1) * 2 * HROWS * LS;
    const int r0 = s * HROWS, valid = min(HROWS, n - r0);
    const size_t row = t0 + r0;
    stage_rows<DW>(buf, LS, (which ? dy : x) + (row * H + h) * P, xstep, HROWS, valid, P,
                   THREADS);
    stage_rows<DW>(buf + HROWS * LS, LS, (which ? cm : bm) + row * N, N, HROWS, valid, N,
                   THREADS);
    if (s == 0 && tid < SEG)
      cp_async_4(sDt + tid, dt + (t0 + (tid < n ? tid : 0)) * H + h, tid < n ? 4 : 0);
    cp_async_commit();
  };
  stage(0);
  float acc[4][3][4] = {};
  for (int s = 0; s < nh; ++s) {
    if (s + 1 < nh)
      stage(s + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // this stage landed
    if (s == 0 && tid < 32) {
      // the decays' sums over the segment's rows, SEG / 32 a lane: each
      // lane's own, then a shuffle scan of the lanes' totals, each a direct
      // sum of dt·a; which 1 the inclusive prefix from the segment's start
      // (coefficient e^{prefix}), which 0 the exclusive suffix from its end
      // (dt·e^{suffix})
      constexpr int PER = SEG / 32;
      const float ah = a[h];
      float v[PER], own = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int t = which ? lane * PER + i : SEG - 1 - (lane * PER + i);
        v[i] = t < n ? sDt[t] * ah : 0.f;
        own += v[i];
      }
      float incl = own;     // the lanes up to this one, inclusive
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float e = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) e = 0.f;       // the earlier lanes' total
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int t = which ? lane * PER + i : SEG - 1 - (lane * PER + i);
        if (which) e += v[i];
        if (t < n) sCo[t] = which ? expf(e) : sDt[t] * expf(e);
        if (!which) e += v[i];
      }
      if (which && lane == 31) dec[seg] = expf(e);
    }
    __syncthreads();
    float* buf = smem + (s & 1) * 2 * HROWS * LS;
    const int r0 = s * HROWS, valid = min(HROWS, n - r0);
    for (int i = tid; i < valid * DW; i += THREADS) buf[(i / DW) * LS + i % DW] *= sCo[r0 + i / DW];
    __syncthreads();
    gram64_acc(acc, buf, buf + HROWS * LS, LS, (valid + 7) & ~7);   // rows past valid are zeros
    __syncthreads();   // every read of this buffer is done
  }
  gram64_store(acc, (which ? gcarry : ustate) + seg * STATE);
}

__global__ void ssd_carry_kernel(float* __restrict__ ustate, float* __restrict__ gcarry,
                                 const float* __restrict__ dec, int nseg, int BH) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)BH * STATE) return;
  const size_t bh = idx / STATE;
  const size_t off = bh * nseg * STATE + idx % STATE;
  carry_entry(ustate + off, gcarry + off, dec + bh * nseg, nseg, STATE, 1);
}

// One block per (head, segment, batch), clusters of g heads.  Thread map:
// warp w, lane l; rows p = 4(2w + l/16).. of the state, columns
// n = 4(l%16)..
__global__ void __launch_bounds__(THREADS, 2)
ssd_segment_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const float* __restrict__ bm,
                   const float* __restrict__ cm, const float* __restrict__ dy,
                   const float* __restrict__ hin, const float* __restrict__ gin,
                   float* __restrict__ dx, float* __restrict__ ddt, double* __restrict__ loc,
                   double* __restrict__ tot,
                   double* __restrict__ dap, double* __restrict__ dts,
                   float* __restrict__ part_db, float* __restrict__ part_dc, int S, int H,
                   int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* sDBC = smem + OFF_DBC;
  float* sRow = smem + OFF_ROW;
  float* sCol = smem + OFF_COL;
  float* sYdy = smem + OFF_YDY;
  float* sDzx = smem + OFF_DZX;

  cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z, nseg = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgp = lane & 15;
  const int p0 = 4 * (2 * warp + (lane >> 4)), n0 = 4 * cgp;
  const int row_of = p0 + 2 * (cgp & 1) + ((cgp >> 1) & 1);
  const int n = min(SEG, S - j * SEG), ntiles = (n + TT - 1) / TT;
  const float ah = a[h];
  const size_t trow = (size_t)b * S + (size_t)j * SEG;        // (b, jSEG)
  const size_t xstep = (size_t)H * P, xbase = (trow * H + h) * P;
  const size_t seg = ((size_t)b * H + h) * nseg + j;

  auto tile_of = [&](int it) { return it < ntiles ? it : 2 * ntiles - 1 - it; };
  auto load = [&](int it) {
    float* buf = smem + (it & 1) * STAGE;
    const int tx = tile_of(it);
    const size_t t0 = trow + (size_t)tx * TT;
    const int valid = min(TT, n - tx * TT);
    stage_rows<DW>(buf + ST_X, DW, x + (t0 * H + h) * P, xstep, TT, valid, P, THREADS);
    stage_rows<DW>(buf + ST_DY, DW, dy + (t0 * H + h) * P, xstep, TT, valid, P, THREADS);
    stage_rows<DW>(buf + ST_B, DW, bm + t0 * N, N, TT, valid, N, THREADS);
    stage_rows<DW>(buf + ST_C, DW, cm + t0 * N, N, TT, valid, N, THREADS);
    if (tid < TT)
      cp_async_4(buf + ST_DT + tid, dt + (t0 + (tid < valid ? tid : 0)) * H + h,
                 tid < valid ? 4 : 0);
    cp_async_commit();
  };
  // item `it`'s tile landed (the next one's load in flight), each step's α
  // taken once
  auto prepare = [&](int it) -> float* {
    if (it + 1 < 2 * ntiles)
      load(it + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // this tile landed
    float* buf = smem + (it & 1) * STAGE;
    if (tid < TT) buf[ST_AL + tid] = expf(buf[ST_DT + tid] * ah);
    __syncthreads();
    return buf;
  };
  // the head terms in sDBC summed over the cluster's heads, in head order,
  // through distributed shared memory, into the group's partial: block
  // rank r sums the segment's rows r, r + g, ...; the cluster waits before
  // (every block's terms are in place) and after (none is overwritten or
  // leaves while another reads it)
  auto cluster_sum = [&](float* __restrict__ part) {
    cluster.sync();
    const int g = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int groups = H / g, grp = h / g;
    const float* rem[MAX_GROUP];
    for (int q = 0; q < g; ++q) rem[q] = cluster.map_shared_rank(sDBC, q);
    const int nrows = rank < n ? (n - rank + g - 1) / g : 0;
    for (int idx = tid; idx < nrows * N; idx += THREADS) {
      const int t = rank + (idx / N) * g, c = idx % N;
      float s = 0.f;
      for (int q = 0; q < g; ++q) s += rem[q][t * DW + c];
      part[((trow + t) * groups + grp) * N + c] = s;
    }
    cluster.sync();
  };
  // the warps' column partials of the tile's steps, summed in order, into
  // the segment's rows t0.. of dst
  auto columns = [&](float* dst, int t0, int nt) {
    for (int idx = tid; idx < nt * DW; idx += THREADS) {
      const int t = idx / DW, c = idx % DW;
      const float* col = sCol + t * WARPS * DW + c;
      float s = col[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += col[w * DW];
      dst[(t0 + t) * DW + c] = s;
    }
  };
  load(0);

  // ---- forwards from h entering the segment: dC's head term Σ_p dy[p] h[p,:]
  {
    float hs[4][4];
    const float* h0 = hin + seg * STATE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(h0 + (p0 + i) * DW + n0);
      hs[i][0] = v.x, hs[i][1] = v.y, hs[i][2] = v.z, hs[i][3] = v.w;
    }
    for (int it = 0; it < ntiles; ++it) {
      const float* buf = prepare(it);
      const float *sX = buf + ST_X, *sDY = buf + ST_DY, *sB = buf + ST_B;
      const float *sDt = buf + ST_DT, *sAl = buf + ST_AL;
      const int t0 = it * TT, nt = min(TT, n - t0);
#pragma unroll 4
      for (int t = 0; t < nt; ++t) {
        const float d = sDt[t], al = sAl[t];
        const float4 x4 = ld4(sX + t * DW + p0), y4 = ld4(sDY + t * DW + p0);
        const float4 b4 = ld4(sB + t * DW + n0);
        const float zz[4] = {d * x4.x, d * x4.y, d * x4.z, d * x4.w};
        const float yy[4] = {y4.x, y4.y, y4.z, y4.w};
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) hs[i][c] = fmaf(al, hs[i][c], zz[i] * bb[c]);
        float colp[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float s = yy[0] * hs[0][c];
#pragma unroll
          for (int i = 1; i < 4; ++i) s = fmaf(yy[i], hs[i][c], s);
          colp[c] = s;
        }
        const float2 cs = col_sum2(colp, lane);
        *reinterpret_cast<float2*>(sCol + (t * WARPS + warp) * DW + n0 + 2 * (lane >> 4)) = cs;
      }
      __syncthreads();
      columns(sDBC, t0, nt);
      __syncthreads();
      // ⟨dy, y⟩ = ⟨C, dC's head term⟩ of each step, a warp a step
      for (int t = warp; t < nt; t += WARPS) {
        const int o = t * DW + lane, od = (t0 + t) * DW + lane;
        const float* sC = buf + ST_C;
        const float s = group_sum<32>(fmaf(sC[o], sDBC[od], sC[o + 32] * sDBC[od + 32]));
        if (lane == 0) sYdy[t0 + t] = s;
      }
      __syncthreads();   // every read of this buffer and the partials is done
    }
  }
  cluster_sum(part_dc);

  // ---- backwards from α G of the later segments: dz = G B (rows), dB's
  // head term Σ_p z[p] G[p,:] (columns), then G ← α G; the tails
  double dl = 0.0, da_acc = 0.0, dt_sum = 0.0;   // warp 0, every lane the same
  {
    float g[4][4];
    const float* g0 = gin + seg * STATE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(g0 + (p0 + i) * DW + n0);
      g[i][0] = v.x, g[i][1] = v.y, g[i][2] = v.z, g[i][3] = v.w;
    }
    for (int it = ntiles; it < 2 * ntiles; ++it) {
      const float* buf = prepare(it);
      const float *sX = buf + ST_X, *sDY = buf + ST_DY, *sB = buf + ST_B, *sC = buf + ST_C;
      const float *sDt = buf + ST_DT, *sAl = buf + ST_AL;
      const int t0 = tile_of(it) * TT, nt = min(TT, n - t0);
#pragma unroll 4
      for (int t = nt - 1; t >= 0; --t) {
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
          for (int c = 0; c < 4; ++c) g[i][c] = fmaf(yy[i], cc[c], g[i][c]);
        float rowp[4], colp[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float s = g[i][0] * bb[0];
#pragma unroll
          for (int c = 1; c < 4; ++c) s = fmaf(g[i][c], bb[c], s);
          rowp[i] = s;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float s = zz[0] * g[0][c];
#pragma unroll
          for (int i = 1; i < 4; ++i) s = fmaf(zz[i], g[i][c], s);
          colp[c] = s;
        }
        const float rs = row_sum16(rowp, lane);
        if (cgp < 4) sRow[t * DW + row_of] = rs;
        const float2 cs = col_sum2(colp, lane);
        *reinterpret_cast<float2*>(sCol + (t * WARPS + warp) * DW + n0 + 2 * (lane >> 4)) = cs;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[i][c] *= al;
      }
      __syncthreads();
      columns(sDBC, t0, nt);
      // dx = dt dz and ⟨dz_t, x_t⟩, a warp a step
      for (int t = warp; t < nt; t += WARPS) {
        const int o = t * DW + lane;
        const float d = sDt[t], z0 = sRow[o], z1 = sRow[o + 32];
        const size_t xo = xbase + (size_t)(t0 + t) * xstep + lane;
        if (lane < P) dx[xo] = d * z0;
        if (lane + 32 < P) dx[xo + 32] = d * z1;
        const float s = group_sum<32>(fmaf(z0, sX[o], z1 * sX[o + 32]));
        if (lane == 0) sDzx[t] = s;
      }
      __syncthreads();
      // dl: the reverse sum of dc_t = ⟨dy, y⟩ − dt ⟨dz, x⟩ inside the
      // segment, a lane a step (a suffix scan over 16 lanes in f64),
      // continued from the later tiles; ddt without dl's offset, da's part
      if (warp == 0) {
        const bool ok = lane < nt;
        const double dzx = ok ? sDzx[lane] : 0.0, d = ok ? sDt[lane] : 0.0;
        double s = ok ? (double)sYdy[t0 + lane] - d * dzx : 0.0;
#pragma unroll
        for (int off = 1; off < TT; off <<= 1) {
          const double o = __shfl_down_sync(0xffffffffu, s, off, TT);
          if (lane + off < TT) s += o;
        }
        const double dlt = dl + s;
        // the last segment's ddt has no offset: rounded here; the others'
        // f64 values wait for theirs in loc
        if (ok) {
          const double v = (double)ah * dlt + dzx;
          const size_t o = (trow + t0 + lane) * H + h;
          if (j == nseg - 1)
            ddt[o] = (float)v;
          else
            loc[o] = v;
        }
        double pa = d * dlt, pd = d;
#pragma unroll
        for (int off = TT / 2; off > 0; off >>= 1) {
          pa += __shfl_xor_sync(0xffffffffu, pa, off, TT);
          pd += __shfl_xor_sync(0xffffffffu, pd, off, TT);
        }
        da_acc += pa;
        dt_sum += pd;
        dl += __shfl_sync(0xffffffffu, s, 0, TT);
      }
      __syncthreads();   // every read of this buffer, the row sums and partials is done
    }
  }
  cp_async_wait<0>();
  if (tid == 0) {
    tot[seg] = dl;
    dap[seg] = da_acc;
    dts[seg] = dt_sum;
  }

  cluster_sum(part_db);
}

// On rows [s·FIN_ROWS, (s + 1)·FIN_ROWS) of segment j of batch row b (block
// (j, b, s)): ddt = loc + a·Σ_{j' > j} tot[j'] (f64, from the last
// segment; the last segment's ddt the segment kernel wrote), and
// dB, dC = the groups' partials summed in order; block (0, 0, 0) also
// da = Σ_{b, j} (dap + offset·dts).  Dynamic shared memory: H doubles.
constexpr int FIN_ROWS = 8;
__global__ void ssd_finish_kernel(float* __restrict__ ddt, float* __restrict__ da,
                                  float* __restrict__ db, float* __restrict__ dc,
                                  const float* __restrict__ a, const double* __restrict__ loc,
                                  const double* __restrict__ tot,
                                  const double* __restrict__ dap,
                                  const double* __restrict__ dts,
                                  const float* __restrict__ part_db,
                                  const float* __restrict__ part_dc, int B, int S, int H,
                                  int N, int groups) {
  extern __shared__ double soff[];
  const int j = blockIdx.x, b = blockIdx.y, nseg = gridDim.x;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.z * FIN_ROWS, t1 = min(min(SEG, S - j * SEG), t0 + FIN_ROWS);
  const size_t trow = (size_t)b * S + (size_t)j * SEG;
  if (j < nseg - 1 && t0 < t1) {
    for (int hh = tid; hh < H; hh += blockDim.x) {
      double off = 0.0;
      for (int jj = nseg - 1; jj > j; --jj) off += tot[((size_t)b * H + hh) * nseg + jj];
      soff[hh] = off;
    }
    __syncthreads();
    for (int idx = t0 * H + tid; idx < t1 * H; idx += blockDim.x) {
      const int hh = idx % H;
      ddt[trow * H + idx] = (float)(loc[trow * H + idx] + (double)a[hh] * soff[hh]);
    }
  }
  for (int idx = t0 * N + tid; idx < t1 * N; idx += blockDim.x) {
    const int t = idx / N, c = idx % N;
    const size_t o = (trow + t) * groups * N + c;
    float sb = 0.f, sc = 0.f;
    for (int q = 0; q < groups; ++q) {
      sb += part_db[o + (size_t)q * N];
      sc += part_dc[o + (size_t)q * N];
    }
    db[(trow + t) * N + c] = sb;
    dc[(trow + t) * N + c] = sc;
  }
  if (j == 0 && b == 0 && blockIdx.z == 0) {
    for (int hh = tid; hh < H; hh += blockDim.x) {
      double s = 0.0;
      for (int bb = 0; bb < B; ++bb) {
        double off = 0.0;
        for (int jj = nseg - 1; jj >= 0; --jj) {
          const size_t sg = ((size_t)bb * H + hh) * nseg + jj;
          s += dap[sg] + off * dts[sg];
          off += tot[sg];
        }
      }
      da[hh] = (float)s;
    }
  }
}

}  // namespace
}  // namespace repro_torch

// The heads of one thread block cluster of the segment kernel, whose dB and
// dC it sums on chip, for H heads.
extern "C" int mamba2_ssd_bwd_group(int H) { return H > 0 ? repro_torch::group_of(H) : 0; }

// The scratch mamba2_ssd_bwd needs, in bytes.
extern "C" long long mamba2_ssd_bwd_scratch(int B, int S, int H, int N) {
  return (long long)repro_torch::scratch_layout(B, S, H, N).bytes;
}

// All tensors f32 and contiguous on one device; P, N <= 64; scratch holds
// mamba2_ssd_bwd_scratch(B, S, H, N) bytes, 16-byte aligned.  Launches four
// kernels (the segments' summaries, the carry, the segments in clusters of
// a head group, the offsets and sums); returns cudaGetLastError() after
// each (or the cluster launch's error).
extern "C" int mamba2_ssd_bwd(const void* x, const void* dt, const void* a, const void* bm,
                              const void* cm, const void* dy, void* dx, void* ddt, void* da,
                              void* db, void* dc, void* scratch, int B, int S, int H, int P,
                              int N, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || P > DW || N > DW)
    return (int)cudaErrorInvalidValue;
  static int sum_done = 0, seg_done = 0;
  cudaError_t err = allow_smem(ssd_summary_kernel, SUM_SMEM_BYTES, sum_done);
  if (err == cudaSuccess) err = allow_smem(ssd_segment_kernel, SMEM_BYTES, seg_done);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const Scratch lay = scratch_layout(B, S, H, N);
  char* base = (char*)scratch;
  double* tot = (double*)(base + lay.tot);
  double* dap = (double*)(base + lay.dap);
  double* dts = (double*)(base + lay.dts);
  double* loc = (double*)(base + lay.loc);
  float* ustate = (float*)(base + lay.ustate);
  float* gcarry = (float*)(base + lay.gcarry);
  float* dec = (float*)(base + lay.dec);
  float* part_db = (float*)(base + lay.part_db);
  float* part_dc = (float*)(base + lay.part_dc);
  const int nseg = (S + SEG - 1) / SEG, g = group_of(H);
  ssd_summary_kernel<<<dim3(2 * nseg, H, B), THREADS, SUM_SMEM_BYTES, st>>>(
      (const float*)x, (const float*)dt, (const float*)a, (const float*)bm, (const float*)cm,
      (const float*)dy, ustate, gcarry, dec, S, H, P, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t entries = (size_t)B * H * STATE;
  ssd_carry_kernel<<<(unsigned)((entries + 255) / 256), 256, 0, st>>>(ustate, gcarry, dec, nseg,
                                                                       B * H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, nseg, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssd_segment_kernel, (const float*)x, (const float*)dt,
                           (const float*)a, (const float*)bm, (const float*)cm,
                           (const float*)dy, (const float*)ustate, (const float*)gcarry,
                           (float*)dx, (float*)ddt, loc, tot, dap, dts, part_db, part_dc, S, H,
                           P, N);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_finish_kernel<<<dim3(nseg, B, SEG / FIN_ROWS), THREADS, H * sizeof(double), st>>>(
      (float*)ddt, (float*)da, (float*)db, (float*)dc, (const float*)a, loc, tot, dap, dts,
      part_db, part_dc, B, S, H, N, H / g);
  return (int)cudaGetLastError();
}

// Blocks of the segment kernel that fit on one SM at once (the occupancy
// API), its threads and shared memory per block, and the segment length.
extern "C" int mamba2_ssd_bwd_occupancy(int* blocks_per_sm, int* threads, int* smem_bytes,
                                        int* segment) {
  using namespace repro_torch;
  static int smem_done = 0;
  cudaError_t err = allow_smem(ssd_segment_kernel, SMEM_BYTES, smem_done);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ssd_segment_kernel,
                                                        THREADS, SMEM_BYTES);
  *threads = THREADS;
  *smem_bytes = SMEM_BYTES;
  *segment = SEG;
  return (int)err;
}
