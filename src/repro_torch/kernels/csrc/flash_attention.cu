// Flash attention forward for Hopper (sm_90a): causal and/or sliding-window
// GQA/MQA attention over q (B,S,H,D) and k, v (B,S,K,D), f32 or bf16.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_fwd
// (body `_kernel`).  Same function: scores are scaled in f32, masked scores
// are -1e30, the online softmax keeps (m, l, acc) in f32 across KV tiles,
// and the output is acc / max(l, 1e-30) in q's dtype.  Any S and H/K ratio,
// head_dim 16, 32, 64, 80 or 128.
//
// What bounds it on the H100: causal prefill at the model's shapes does
// ~S/2 multiply-adds per q element read, far above the card's ~295 bf16
// operations per byte, so the bound is the tensor-core rate.  Both designs
// keep every intermediate on chip and skip KV tiles that lie wholly
// outside the causal or window band (the TPU kernel visits them masked;
// the result is the same).
//
// bfloat16: warpgroup MMA fed by TMA (flash_wgmma_kernel).  A block owns
// one (batch, head, 128-row q tile) and has three warpgroups.  The first
// gives up registers (setmaxnreg) and one of its threads TMA-loads the Q
// tile once and then K and V tiles of 64 keys into a ring of STAGES
// buffers, each signalled by an mbarrier; the tensor maps describe q, k
// and v in their (B,S,H,D) / (B,S,K,D) layouts, so nothing is transposed
// or copied first, and rows past S arrive as zeros.  The other two each
// own 64 q rows (wgmma's M): S = Q K^T by wgmma from shared memory (both
// K-major), the online softmax on the accumulator fragments in registers
// (a row lives in 4 lanes: 2-step shuffles), masks only on tiles that
// cross the diagonal, the window's edge or S, then O += P V by wgmma with
// P from registers and V MN-major (the transpose bit).  Scores are scaled
// into the log2 domain (by log2(e)/sqrt(D)) and exponentiated by ex2.approx,
// which differs from exp of the scaled score by rounding.  S of the next tile
// is issued with P V of the current one, so the softmax overlaps a
// product; the blocks of the longest causal q tiles start first.  The reference
// multiplies p by v in f32; one bf16 rounding of P would put up to
// 2^-8 * sum p|v| / l on an output, beyond the bf16 tolerance for outputs
// near zero, so P is split into hi = bf16(p) and lo = bf16(p - hi) and
// both are multiplied (1.5 x the tensor work of the plain algorithm).  The
// output is staged in the warpgroup's Q rows and TMA-stored (rows past S
// are dropped).
//
// Problems met, and what the design does:
// - cuTensorMapEncodeTiled is a driver-API function and the libraries link
//   only the runtime: it is fetched through cudaGetDriverEntryPointByVersion
//   (hopper.cuh).  The maps are encoded on the host for every call and
//   passed by value as __grid_constant__ parameters, so a captured CUDA
//   graph replays them with the pointers it captured.
// - A swizzled TMA box's inner extent must fit the swizzle span.  head_dim
//   64 and 128 load as 64-column boxes with the 128-byte swizzle; 32 as one
//   box with the 64-byte swizzle; 16 and 80 (160-byte rows, zamba2's shared
//   block) as 16-column boxes with the 32-byte swizzle.  The wgmma
//   descriptors name the same swizzle and strides (hopper.cuh's note).
// - TMA needs 16-byte aligned bases and strides: strides are H*D*2 and
//   K*D*2 bytes (D a multiple of 8); the wrapper checks the base pointers.
// - Rows with nothing allowed in a tile keep the -1e30 sentinel: their junk
//   exp(0) = 1 is wiped by the later correction exp(m_prev - m_new) = 0.
// - The two consumer warpgroups share each K/V stage: the producer waits
//   until all eight consumer warps have released it (an mbarrier of
//   count 8), and a warpgroup that skips a tile still waits for it, so
//   the barrier phases never run ahead.
// - Registers: S (32 f32), O (D/2 f32) and P hi/lo (32 b32) per thread at
//   64-key tiles; -Xptxas -v (printed by chip_smoke.py's build phase)
//   reports the count and any spill.
//
// float32: the first version's f32 FMA kernel (flash_fwd_kernel) stays:
// TF32 would not hold f32's 2e-5, and the main path is bf16.  A block owns
// one (batch, head, 64-row q tile) and stages K and V through shared
// memory as f32; thread map (256 threads): lane group ty = tid/16 owns q
// rows 4ty..4ty+3, lane tx = tid%16 owns score columns tx+16j and output
// columns tx+16c; row reductions are 16-lane shuffles.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 256;  // 16 lane groups x 16 lanes

template <int D>
constexpr int flash_smem_bytes() {
  // Q and K rows padded to D+1 floats, P rows to BK+1: conflict-free columns
  return (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int H, int KH, int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x DP
  float* sK = sQ + BQ * DP;    // BK x DP
  float* sV = sK + BK * DP;    // BK x D
  float* sP = sV + BK * D;     // BQ x PP

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, s = q0 + r;
    sQ[r * DP + d] = s < S ? to_f32(q[((size_t)(b * S + s) * H + h) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // KV tiles that intersect the allowed band of this q tile
  const int q_last = min(q0 + BQ - 1, S - 1);
  int hi = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  int lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  lo = min(lo, max(hi - 1, 0));

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // Q visible; previous tile's readers done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D, s = k0 + r;
      const size_t off = ((size_t)(b * S + s) * KH + kh) * D + d;
      sK[r * DP + d] = s < S ? to_f32(k[off]) : 0.f;
      sV[r * D + d] = s < S ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = sK[(tx + 16 * jj) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = fmaf(qv[i], kv[jj], sc[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kp = k0 + tx + 16 * jj;
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        sc[i][jj] = ok ? sc[i][jj] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][jj]);
      }
      mx = group_max<16>(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(sc[i][jj] - m_new);
        sP[(ty * 4 + i) * PP + tx + 16 * jj] = p;
        rs += p;
      }
      rs = group_sum<16>(rs);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = sV[c * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)(b * S + s) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) orow[tx + 16 * cc] = from_f32<T>(acc[i][cc] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KH, int causal, int window, cudaStream_t stream) {
  static int smem_done = 0;
  constexpr int smem = flash_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem, smem_done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KH, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KH, int D, int causal, int window,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KH, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KH, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KH, causal, window, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, S, H, KH, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KH, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- bf16 ----
namespace wg {

// (Measured no faster: 128-key tiles; one consumer warpgroup per block at
// two blocks per SM.)
constexpr int CONSUMERS = 2;                     // consumer warpgroups of 64 q rows
constexpr int BQ = 64 * CONSUMERS;               // q rows per block
constexpr int BK = 64;                           // keys per KV tile
constexpr int STAGES = 3;                        // K/V ring depth
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer warpgroup
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;               // 128 x 40 + 256 x 232 <= 65,536

template <int D>
struct Tile {
  static constexpr int SWB = D % 64 == 0 ? 128 : D == 32 ? 64 : 32;  // swizzle = box row bytes
  static constexpr int E = SWB / 2;                                   // columns per box
  static constexpr int NB = D / E;                                    // boxes per row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;                         // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES; // 1024: alignment slack
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap o_map, int S, int H, int KH,
                   int causal, int window, float scale_log2) {
  using T = Tile<D>;
  constexpr int SWB = T::SWB, E = T::E, NB = T::NB;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES], empty_bar[STAGES], q_bar;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;                     // box b at b * BQ * SWB, rows 0 .. BQ-1
  uint8_t* sKV = smem + T::Q_BYTES;       // stage s: K at 2s * KV_BYTES, V after it

  // blocks start in order of blockIdx, x fastest: every (head, batch) of
  // the last, longest causal q tile first
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * BQ;
  const int h = blockIdx.x, b = blockIdx.y, kh = h / (H / KH);
  const int warp = threadIdx.x / 32;

  // KV tiles that intersect the band of this q tile
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int hi = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  int lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  lo = min(lo, max(hi - 1, 0));

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], CONSUMER_WARPS);
    }
    mbar_init(&q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every TMA load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&q_bar, T::Q_BYTES);
      for (int w = 0; w < CONSUMERS; ++w)
        for (int bx = 0; bx < NB; ++bx)
          tma_load_4d(&q_map, &q_bar, sQ + bx * BQ * SWB + w * 64 * SWB, bx * E, h, q0 + 64 * w, b);
      for (int j = lo, i = 0; j < hi; ++j, ++i) {
        const int st = i % STAGES;
        mbar_wait(&empty_bar[st], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full_bar[st], 2 * T::KV_BYTES);
        uint8_t* sK = sKV + 2 * st * T::KV_BYTES;
        uint8_t* sV = sK + T::KV_BYTES;
        for (int bx = 0; bx < NB; ++bx) {
          tma_load_4d(&k_map, &full_bar[st], sK + bx * BK * SWB, bx * E, kh, j * BK, b);
          tma_load_4d(&v_map, &full_bar[st], sV + bx * BK * SWB, bx * E, kh, j * BK, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 q rows each
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = warp / 4 - 1;                 // this consumer warpgroup: 0 .. CONSUMERS-1
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int wrow = (t / 32) * 16 + lane / 4;   // this thread's first row in the warpgroup
  const int first = q0 + 64 * cw;              // the warpgroup's rows: first .. first + 63
  const int last = first + 63;
  const int r0 = first + wrow, r1 = r0 + 8;    // the two rows this thread holds

  // the warpgroup's own tiles [lo_w, hi_w): those that intersect its band
  int lo_w = lo, hi_w = hi;
  if (causal) hi_w = min(hi_w, last / BK + 1);
  if (window > 0) lo_w = max(lo_w, max(0, first - window + 1) / BK);
  if (first >= S) hi_w = lo_w;

  float o[D / 2], s[BK / 2];
  uint32_t ph[BK / 16][4], pl[BK / 16][4];    // P as wgmma A fragments, bf16 hi and lo
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const uint32_t q_addr = smem_u32(sQ) + cw * 64 * SWB;
  auto k_addr = [&](int i) { return smem_u32(sKV + 2 * (i % STAGES) * T::KV_BYTES); };

  // S = Q K^T for the tile in ring slot i (issued, not waited for)
  auto issue_qk = [&](int i) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = ((kk * 16) % E) * 2;   // byte offset of the k-step in its box
      const uint32_t box = (kk * 16) / E;
      const uint64_t da = gmma_desc<SWB>(q_addr + box * BQ * SWB + col, 16, 8 * SWB);
      const uint64_t db = gmma_desc<SWB>(k_addr(i) + box * BK * SWB + col, 16, 8 * SWB);
      wgmma_ss<BK>(s, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // O += P V for the tile in ring slot i, P = hi + lo (issued, not waited for)
  auto issue_pv = [&](int i) {
    const uint32_t v_addr = k_addr(i) + T::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = gmma_desc<SWB>(v_addr + kk * 16 * SWB, BK * SWB, 8 * SWB);
      wgmma_rs_tb<D>(o, ph[kk], dv, 1);
      wgmma_rs_tb<D>(o, pl[kk], dv, 1);
    }
    wgmma_commit();
  };
  // scale and mask the scores of the tile at key k0, update the running max
  // and turn s into p = exp2(s - m); returns the corrections and row sums
  auto softmax = [&](int k0, float& c0, float& c1, float& rs0, float& rs1) {
    const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > first) ||
                        (window > 0 && k0 <= last - window);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * n + e];
        x *= scale_log2;
        if (masked) {
          const int kp = k0 + 8 * n + 2 * (lane % 4) + (e & 1);
          const int qp = e < 2 ? r0 : r1;
          bool ok = kp < S;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          if (!ok) x = NEG_INF;
        }
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    c0 = fast_exp2(m0 - mn0);
    c1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    rs0 = rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[4 * n] = fast_exp2(s[4 * n] - mn0);
      s[4 * n + 1] = fast_exp2(s[4 * n + 1] - mn0);
      s[4 * n + 2] = fast_exp2(s[4 * n + 2] - mn1);
      s[4 * n + 3] = fast_exp2(s[4 * n + 3] - mn1);
      rs0 += s[4 * n] + s[4 * n + 1];
      rs1 += s[4 * n + 2] + s[4 * n + 3];
    }
  };
  // rescale O and l by the corrections, and split p into the A fragments:
  // k-step kk takes the accumulator's column blocks 2kk and 2kk+1
  auto rescale_and_split = [&](float c0, float c1, float rs0, float rs1) {
    l0 = l0 * c0 + rs0;   // this thread's columns only; summed over the row's 4 lanes at the end
    l1 = l1 * c1 + rs1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= c0;
      o[4 * n + 1] *= c0;
      o[4 * n + 2] *= c1;
      o[4 * n + 3] *= c1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = s[8 * kk + 2 * r], y = s[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hv = __floats2bfloat162_rn(x, y);
        const __nv_bfloat162 lv = __floats2bfloat162_rn(x - __low2float(hv), y - __high2float(hv));
        ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hv);
        pl[kk][r] = *reinterpret_cast<const uint32_t*>(&lv);
      }
    }
  };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[i % STAGES]);
  };
  auto wait_full = [&](int i) { mbar_wait(&full_bar[i % STAGES], (i / STAGES) & 1); };

  // Ring slot i holds tile lo + i.  Tiles outside [lo_w, hi_w) are waited
  // for and released unread, so that both warpgroups keep the barriers'
  // phases.  Inside, S = Q K^T of tile j is issued together with P V of
  // tile j-1, and the softmax of tile j runs while that P V product does;
  // the registers P V reads (O, P) are touched only after it is waited for.
  mbar_wait(&q_bar, 0);
  int i = 0;
  for (; lo + i < lo_w; ++i) {
    wait_full(i);
    release(i);
  }
  if (lo_w < hi_w) {
    float c0, c1, rs0, rs1;
    wait_full(i);
    wgmma_fence();
    issue_qk(i);
    wgmma_wait<0>();
    fence_operands(s);
    softmax((lo + i) * BK, c0, c1, rs0, rs1);
    rescale_and_split(c0, c1, rs0, rs1);
    for (++i; lo + i < hi_w; ++i) {
      wait_full(i);
      wgmma_fence();
      issue_qk(i);
      issue_pv(i - 1);
      wgmma_wait<1>();           // S of tile i is done; P V of tile i-1 may still run
      fence_operands(s);
      softmax((lo + i) * BK, c0, c1, rs0, rs1);
      wgmma_wait<0>();
      fence_operands(o);
      fence_operands(ph);
      fence_operands(pl);
      release(i - 1);
      rescale_and_split(c0, c1, rs0, rs1);
    }
    wgmma_fence();
    issue_pv(i - 1);
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(ph);
    fence_operands(pl);
    release(i - 1);
  }
  for (; lo + i < hi; ++i) {
    wait_full(i);
    release(i);
  }

  // ---- epilogue: O / max(l, 1e-30) into this warpgroup's Q rows (the same
  // swizzled layout), then one TMA store per box; rows past S are dropped
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  uint8_t* sO = sQ + cw * 64 * SWB;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * (lane % 4);
    const int bx = col / E;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = wrow + 8 * rr;
      const float dd = rr ? d1 : d0;
      const __nv_bfloat162 v2 =
          __floats2bfloat162_rn(o[4 * n + 2 * rr] / dd, o[4 * n + 2 * rr + 1] / dd);
      const uint32_t off = swizzle<SWB>(row * SWB + (col % E) * 2);
      *reinterpret_cast<__nv_bfloat162*>(sO + bx * BQ * SWB + off) = v2;
    }
  }
  fence_proxy_async_smem();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  if (t == 0 && first < S) {
    for (int bx = 0; bx < NB; ++bx)
      tma_store_4d(&o_map, sO + bx * BQ * SWB, bx * E, h, first, b);
    tma_store_commit_and_wait();
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KH,
           int causal, int window, cudaStream_t stream) {
  using T = Tile<D>;
  static int smem_done = 0;
  cudaError_t err = allow_smem(flash_wgmma_kernel<D>, T::SMEM, smem_done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm, om;
  if (!encode_bf16_4d<T::SWB>(&qm, q, D, H, S, B, 64) ||
      !encode_bf16_4d<T::SWB>(&km, k, D, KH, S, B, BK) ||
      !encode_bf16_4d<T::SWB>(&vm, v, D, KH, S, B, BK) ||
      !encode_bf16_4d<T::SWB>(&om, o, D, H, S, B, 64))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_wgmma_kernel<D><<<grid, THREADS, T::SMEM, stream>>>(qm, km, vm, om, S, H, KH, causal,
                                                            window, scale_log2);
  return (int)cudaGetLastError();
}

int dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KH,
               int D, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, S, H, KH, causal, window, stream);
    case 32: return launch<32>(q, k, v, o, B, S, H, KH, causal, window, stream);
    case 64: return launch<64>(q, k, v, o, B, S, H, KH, causal, window, stream);
    case 80: return launch<80>(q, k, v, o, B, S, H, KH, causal, window, stream);
    case 128: return launch<128>(q, k, v, o, B, S, H, KH, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace
}  // namespace repro_torch

// window <= 0 means no window.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int H, int KH, int D,
                                   int causal, int window, int dtype,
                                   void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return dispatch_d<float>(q, k, v, o, B, S, H, KH, D, causal, window, st);
  if (dtype == DTYPE_BF16) return wg::dispatch_d(q, k, v, o, B, S, H, KH, D, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
