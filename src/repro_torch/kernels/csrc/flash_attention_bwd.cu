// Flash attention backward for Hopper (sm_90a): the gradient of causal
// and/or sliding-window GQA/MQA attention over q (B,S,H,D) and k, v
// (B,S,K,D), f32 or bf16, given the forward's output o, its gradient dO and
// the rows' log-sum-exp that the forward kernel wrote.
//
// Replaces the gradient that the JAX package takes of its jnp attention
// (repro/models/attention.py: dense_attention, chunked_attention); the TPU
// package has no Pallas backward.  Same function as
// kernels/ref.py::flash_attention_bwd_ref: with P = softmax(mask(Q K^T *
// scale)), dV = sum over the group of P^T dO, dP = dO V^T, dS = P o (dP -
// rowsum(dO o O)), dQ = dS K * scale, dK = sum over the group of dS^T Q *
// scale.  Every product accumulates in f32; dq, dk and dv are written in
// the inputs' dtype.  Any S and H/K ratio, head_dim 16, 32, 64, 80 or 128.
//
// What bounds it on the H100: the five products of the causal half do
// ~S/2 multiply-adds per element read, so the tensor-core rate is the
// bound.  Each row's lse (log2 domain: lse = log2 sum_t exp2(s_t), s the
// scores times log2(e)/sqrt(D)) comes from the forward kernel, so no pass
// recomputes it: P = exp2(s - lse) is rebuilt from one product.  Masked
// entries are set to P = 0, never exp2 of the -1e30 sentinel, so no
// sentinel reaches dS.  Three launches, none with atomics, so the
// gradients are the same bits from run to run (this repo studies run-to-
// run variation; an f32 atomicAdd into a dQ accumulator would sum in the
// order the blocks happen to run):
//
// 1. delta_kernel: delta = rowsum(dO o O) into f32 (B,H,S) scratch, bound
//    by the bytes of O and dO: 16-byte loads, a block's rows summed in
//    shared memory in a fixed order.
// 2. dK and dV per 64-key tile (the KV head's group summed on chip).
// 3. dQ per q tile.
//
// bfloat16: warpgroup MMA fed by TMA, structured like the forward
// (flash_attention.cu): three warpgroups, the first gives up registers
// (setmaxnreg) and one of its threads issues every TMA load into rings of
// shared-memory stages guarded by mbarriers; the forward's tensor maps and
// swizzles (128-byte at head_dim 64 and 128, 64-byte at 32, 32-byte with
// 16-column boxes at 16 and 80).  P and dS feed the tensor cores as bf16,
// each split into hi = bf16(x) and lo = bf16(x - hi), both multiplied: one
// rounding of either puts up to 2^-9 of sum |x y| on a gradient, beyond
// the bf16 band for gradients near zero, for each of dV, dK and dQ
// (tests/test_torch_kernels.py models the arithmetic and shows each single
// rounding failing).  So the kernels run ten products of the causal half
// where the bound counts five.
//
// - dkdv_wgmma_kernel: a block owns 64 keys of one (batch, KV head); its
//   K and V tiles are TMA-loaded once.  The block's work is the list of
//   (group head, 64-row q tile) items whose band meets its keys; items
//   stream through a ring of 4 stages (Q, dO, and the rows' lse and delta
//   slices by 1-d TMA), and item i goes to consumer warpgroup i % 2, so
//   both consumers own the same 64 keys (wgmma's M) and split the work
//   evenly at any group size.  Per item: S^T = K Q^T and dP^T = V dO^T by
//   wgmma from shared memory (both K-major), P^T = exp2(S^T - lse) (0
//   where masked, masks only on tiles that cross the diagonal, the
//   window's edge or S), dS^T = P^T o (dP^T - delta) in registers, then
//   dV += P^T dO and dK += dS^T Q by wgmma with the A operand from
//   registers (the accumulator layout, as the forward feeds P) and dO / Q
//   MN-major.  The group's sum stays in registers; at the end the two
//   consumers swap halves through shared memory (consumer 0 sums dK,
//   consumer 1 dV, each as c0 + c1) and TMA-store them.  Registers at
//   head_dim 128: dK and dV 2 x 64, S^T and dP^T 2 x 32, turned in place
//   into the bf16 hi/lo fragments (two f32 become two bf16x2).  Grid
//   (K, B, key tiles), key tile 0 (under causality the longest list)
//   first: at qwen3-4b's training shape 16 x 8 x 2 = 256 blocks of 4 to
//   64 items (2 to 32 a consumer), one block an SM.
//   Accumulation order: the tensor core adds each k-step's products into
//   the f32 accumulator with an error relative to the accumulator (not
//   round-to-nearest f32), so over a long chain (mixtral's 4096 window: 390
//   items, 1,560 k-steps into dV for a key tile near the start) a partial
//   sum near 1 that later cancels leaves ~5e-5 on a gradient near zero,
//   outside the bf16 band.  Under causality P is largest on the rows
//   nearest the keys (the fewest keys in their softmax), so a block takes
//   its q tiles farthest first and the diagonal tile last: the large
//   terms enter the sum at its end, after few steps.
// - dq_wgmma_kernel: the forward's grid and shape: a block owns 128 q rows
//   of one (batch, head), the longest causal q tiles first; Q and dO are
//   TMA-loaded once, K and V tiles of 64 keys stream through a ring of 3
//   stages; each consumer warpgroup owns 64 rows: S = Q K^T and dP = dO
//   V^T (wgmma_ss), dS = P o (dP - delta) in registers, dQ += dS K
//   (wgmma, dS from registers, K MN-major).  The products of the next KV
//   tile are issued together with dQ's product of the current one.  At
//   the training shape 32 x 2 x 8 = 512 blocks of 2 to 16 KV tiles.
//
// float32: the first version's FMA kernels stay (TF32 would not hold f32's
// 2e-5), reading the same lse and delta: one block per (batch, KV head,
// 64-key tile) for dK/dV (q tiles farthest first, the group's q heads
// within each, in a loop) and
// one per (batch, head, 64-row q tile) for dQ; tiles staged in shared
// memory as f32 (thread map as the forward's f32 kernel: lane group
// ty = tid/16 owns rows 4ty..4ty+3, lane tx = tid%16 columns tx+16j).

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int BT = 64;  // keys of a KV tile, rows of a q tile (both designs)

__device__ __forceinline__ bool allowed(int qp, int kp, int S, int causal, int window) {
  bool ok = qp < S && kp < S;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// ---- 1. delta = rowsum(dO o O), both dtypes
// A row of D values is CH chunks of 16 bytes; a block takes RB whole rows,
// one thread a chunk.  The rows of (B,S,H,D) are b*S*H + s*H + h.
template <typename T, int D>
struct DeltaShape {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int CH = D / VEC;
  static constexpr int RB = 256 / CH;
  static constexpr int THREADS = RB * CH;
};

template <typename T, int D>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int S, int H, long rows) {
  using P = DeltaShape<T, D>;
  __shared__ float part[P::THREADS];
  const int t = threadIdx.x;
  const long row0 = (long)blockIdx.x * P::RB;
  const long row = row0 + t / P::CH;
  float acc = 0.f;
  if (row < rows) {
    const size_t off = (size_t)row * D + (t % P::CH) * P::VEC;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + off);
    const T* av = reinterpret_cast<const T*>(&a);
    const T* gv = reinterpret_cast<const T*>(&g);
#pragma unroll
    for (int e = 0; e < P::VEC; ++e) acc = fmaf(to_f32(gv[e]), to_f32(av[e]), acc);
  }
  part[t] = acc;
  __syncthreads();
  const long r = row0 + t;
  if (t < P::RB && r < rows) {
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < P::CH; ++c) sum += part[t * P::CH + c];
    const long b = r / ((long)S * H), s = (r / H) % S, h = r % H;
    delta[((size_t)b * H + h) * S + s] = sum;
  }
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, float* delta, int B, int S, int H,
                 cudaStream_t stream) {
  using P = DeltaShape<T, D>;
  const long rows = (long)B * S * H;
  delta_kernel<T, D><<<(unsigned)((rows + P::RB - 1) / P::RB), P::THREADS, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, S, H, rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- f32 ----
constexpr int THREADS = 256;  // 16 lane groups x 16 lanes
constexpr int PP = BT + 1;    // pitch of the P / dS tiles

// rows r0 .. r0+63 of head hh of a (B,S,NH,D) tensor into a f32 tile of
// pitch D+1; rows past S are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int b,
                                          int r0, int hh, int S, int NH) {
  for (int i = threadIdx.x; i < BT * D; i += THREADS) {
    const int r = i / D, d = i % D, s = r0 + r;
    dst[r * (D + 1) + d] = s < S ? src[((size_t)(b * S + s) * NH + hh) * D + d] : 0.f;
  }
}

// c[i][j] = sum_d A[4ty+i][d] * Bm[tx+16j][d]: this thread's 4x4 block of A B^T
template <int D>
__device__ __forceinline__ void block_abt(float (&c)[4][4], const float* A, const float* Bm,
                                          int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = Bm[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], bb[j], c[i][j]);
  }
}

// KV tiles [lo, hi) that intersect the band of the q tile at q0
__device__ __forceinline__ void kv_range(int q0, int S, int causal, int window, int& lo, int& hi) {
  const int q_last = min(q0 + BT - 1, S - 1);
  hi = causal ? q_last / BT + 1 : (S + BT - 1) / BT;
  lo = window > 0 ? max(0, q0 - window + 1) / BT : 0;
  lo = min(lo, max(hi - 1, 0));
}

template <int D>
constexpr int dkdv_smem_bytes() { return (4 * BT * (D + 1) + 2 * BT * PP + 2 * BT) * 4; }
template <int D>
constexpr int dq_smem_bytes() { return (4 * BT * (D + 1) + BT * PP) * 4; }

// ---- 2. dK and dV per KV tile, summed over the group's heads in registers
template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KH, int causal,
            int window, float scale_log2, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;            // BT x DP
  float* sV = sK + BT * DP;    // BT x DP
  float* sQ = sV + BT * DP;    // BT x DP
  float* sO = sQ + BT * DP;    // BT x DP: dO
  float* sP = sO + BT * DP;    // BT x PP: P, q rows x key columns
  float* sS = sP + BT * PP;    // BT x PP: dS
  float* sL = sS + BT * PP;    // BT: lse of the q tile's rows
  float* sD = sL + BT;         // BT: delta
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BT, kh = blockIdx.y, b = blockIdx.z, G = H / KH;

  load_tile<D>(sK, k, b, k0, kh, S, KH);
  load_tile<D>(sV, v, b, k0, kh, S, KH);

  // q tiles whose rows can see a key of this tile: q >= k0 (causal) and
  // q <= k_last + window - 1
  const int nq = (S + BT - 1) / BT;
  const int k_last = min(k0 + BT - 1, S - 1);
  const int qlo = causal ? k0 / BT : 0;
  const int qhi = window > 0 ? min(nq, (k_last + window - 1) / BT + 1) : nq;

  float ak[4][DC], av[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) ak[i][c] = av[i][c] = 0.f;

  // the farthest q tile first, as the bf16 kernel (the note on accumulation
  // order): the long f32 chain then adds its largest terms last
  for (int qt = qhi - 1; qt >= qlo; --qt) {
    const int q0 = qt * BT;
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;
      __syncthreads();  // K, V visible; the previous tile's readers done
      load_tile<D>(sQ, q, b, q0, h, S, H);
      load_tile<D>(sO, dout, b, q0, h, S, H);
      for (int r = tid; r < BT; r += THREADS) {
        const int s = q0 + r;
        sL[r] = s < S ? lse[((size_t)b * H + h) * S + s] : 0.f;
        sD[r] = s < S ? delta[((size_t)b * H + h) * S + s] : 0.f;
      }
      __syncthreads();
      float sc[4][4], dp[4][4];
      block_abt<D>(sc, sQ, sK, ty, tx);
      block_abt<D>(dp, sO, sV, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = tx + 16 * jj;
          const float p = allowed(q0 + r, k0 + c, S, causal, window)
                              ? exp2f(sc[i][jj] * scale_log2 - sL[r]) : 0.f;
          sP[r * PP + c] = p;
          sS[r * PP + c] = p * (dp[i][jj] - sD[r]);
        }
      }
      __syncthreads();
      // dV[kr][c] += sum_r P[r][kr] dO[r][c];  dK[kr][c] += sum_r dS[r][kr] Q[r][c]
#pragma unroll 4
      for (int r = 0; r < BT; ++r) {
        float pp[4], ss[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pp[i] = sP[r * PP + ty * 4 + i];
          ss[i] = sS[r * PP + ty * 4 + i];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float ov = sO[r * DP + tx + 16 * c];
          const float qv = sQ[r * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            av[i][c] = fmaf(pp[i], ov, av[i][c]);
            ak[i][c] = fmaf(ss[i], qv, ak[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty * 4 + i;
    if (s >= S) continue;
    const size_t row = ((size_t)(b * S + s) * KH + kh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[row + tx + 16 * c] = ak[i][c] * scale;
      dv[row + tx + 16 * c] = av[i][c];
    }
  }
}

// ---- 3. dQ per q tile
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, int S, int H, int KH,
          int causal, int window, float scale_log2, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;            // BT x DP
  float* sO = sQ + BT * DP;    // BT x DP: dO
  float* sK = sO + BT * DP;    // BT x DP
  float* sV = sK + BT * DP;    // BT x DP
  float* sS = sV + BT * DP;    // BT x PP: dS
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, kh = h / (H / KH);

  load_tile<D>(sQ, q, b, q0, h, S, H);
  load_tile<D>(sO, dout, b, q0, h, S, H);
  float rl[4], rd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    rl[i] = s < S ? lse[((size_t)b * H + h) * S + s] : 0.f;
    rd[i] = s < S ? delta[((size_t)b * H + h) * S + s] : 0.f;
  }
  float aq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) aq[i][c] = 0.f;

  int lo, hi;
  kv_range(q0, S, causal, window, lo, hi);
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BT;
    __syncthreads();  // Q, dO visible; the previous tile's readers done
    load_tile<D>(sK, k, b, k0, kh, S, KH);
    load_tile<D>(sV, v, b, k0, kh, S, KH);
    __syncthreads();
    float sc[4][4], dp[4][4];
    block_abt<D>(sc, sQ, sK, ty, tx);
    block_abt<D>(dp, sO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const float p = allowed(q0 + r, k0 + c, S, causal, window)
                            ? exp2f(sc[i][jj] * scale_log2 - rl[i]) : 0.f;
        sS[r * PP + c] = p * (dp[i][jj] - rd[i]);
      }
    }
    __syncthreads();
    // dQ[r][c] += sum_kc dS[r][kc] K[kc][c]
#pragma unroll 4
    for (int kc = 0; kc < BT; ++kc) {
      float ss[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ss[i] = sS[(ty * 4 + i) * PP + kc];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = sK[kc * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) aq[i][c] = fmaf(ss[i], kv, aq[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const size_t row = ((size_t)(b * S + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[row + tx + 16 * c] = aq[i][c] * scale;
  }
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, const float* o,
               const float* dout, const float* lse, float* dq, float* dk, float* dv,
               float* delta, int B, int S, int H, int KH, int causal, int window,
               cudaStream_t stream) {
  static int dkdv_done = 0, dq_done = 0;
  cudaError_t err = allow_smem(dkdv_kernel<D>, dkdv_smem_bytes<D>(), dkdv_done);
  if (err == cudaSuccess) err = allow_smem(dq_kernel<D>, dq_smem_bytes<D>(), dq_done);
  if (err != cudaSuccess) return (int)err;
  const int nt = (S + BT - 1) / BT;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  int e = launch_delta<float, D>(o, dout, delta, B, S, H, stream);
  if (e) return e;
  dkdv_kernel<D><<<dim3(nt, KH, B), THREADS, dkdv_smem_bytes<D>(), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, H, KH, causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<D><<<dim3(nt, H, B), THREADS, dq_smem_bytes<D>(), stream>>>(
      q, k, v, dout, lse, delta, dq, S, H, KH, causal, window, scale_log2, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 ----
namespace wg {

constexpr int THREADS = 384;                  // the producer warpgroup + two consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;            // 128 x 24 + 256 x 240 <= 65,536
constexpr int KV_STAGES = 4;                  // dK/dV's Q/dO ring: two stages a consumer
constexpr int DQ_STAGES = 3;                  // dQ's K/V ring
constexpr int DQ_ROWS = 128;                  // q rows of a dQ block

template <int D>
struct Tile {
  static constexpr int SWB = D % 64 == 0 ? 128 : D == 32 ? 64 : 32;  // swizzle = box row bytes
  static constexpr int E = SWB / 2;                                   // columns per box
  static constexpr int NB = D / E;                                    // boxes per row
  static constexpr int T64 = BT * D * 2;                              // a 64-row bf16 tile
  // dK/dV: K, V, the ring's Q and dO tiles, then its lse and delta slices
  static constexpr int KV_SMEM = 1024 + 2 * T64 + KV_STAGES * (2 * T64 + 2 * BT * 4);
  // dQ: the block's Q and dO (128 rows each), then the K/V ring
  static constexpr int DQ_SMEM = 1024 + 4 * T64 + DQ_STAGES * 2 * T64;
};

// acc (a 64-row by D accumulator of this warpgroup) as bf16 into a 64-row
// swizzled tile (boxes of E columns, box stride `box_bytes`)
template <int D>
__device__ __forceinline__ void stage_out(const float (&acc)[D / 2], float mul, uint8_t* dst,
                                          int box_bytes, int wrow, int lane) {
  constexpr int SWB = Tile<D>::SWB, E = Tile<D>::E;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * (lane % 4);
    const int bx = col / E;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = wrow + 8 * rr;
      const __nv_bfloat162 v2 =
          __floats2bfloat162_rn(acc[4 * n + 2 * rr] * mul, acc[4 * n + 2 * rr + 1] * mul);
      const uint32_t off = swizzle<SWB>(row * SWB + (col % E) * 2);
      *reinterpret_cast<__nv_bfloat162*>(dst + bx * box_bytes + off) = v2;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap do_map,
                  const __grid_constant__ CUtensorMap dk_map,
                  const __grid_constant__ CUtensorMap dv_map,
                  const __grid_constant__ CUtensorMap lse_map,
                  const __grid_constant__ CUtensorMap delta_map, int S, int H, int KH,
                  int causal, int window, float scale_log2, float scale) {
  using T = Tile<D>;
  constexpr int SWB = T::SWB, E = T::E, NB = T::NB, T64 = T::T64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[KV_STAGES], empty_bar[KV_STAGES], kv_bar;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;                                   // box b at b * BT * SWB
  uint8_t* sV = sK + T64;
  uint8_t* ring = sV + T64;                             // stage s: Q at 2s * T64, dO after it
  float* sLD = reinterpret_cast<float*>(ring + KV_STAGES * 2 * T64);  // stage s: lse, delta

  const int kh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z, k0 = kt * BT;
  const int G = H / KH;
  const int warp = threadIdx.x / 32;
  // the items: (group head, q tile) with q tiles [qlo, qhi) whose rows can
  // see a key of this tile (q >= k0 under causality, q <= k_last + window - 1)
  const int nq = (S + BT - 1) / BT;
  const int k_last = min(k0 + BT - 1, S - 1);
  const int qlo = causal ? kt : 0;
  const int qhi = window > 0 ? min(nq, (k_last + window - 1) / BT + 1) : nq;
  const int items = G * (qhi - qlo);
  // item i: q tile qhi - 1 - i / G of head kh * G + i % G, the q tile
  // farthest from the keys first (see the note on accumulation order)
  auto item_q0 = [&](int i) { return (qhi - 1 - i / G) * BT; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4);   // the four warps of the stage's consumer
    }
    mbar_init(&kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every TMA load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&kv_bar, 2 * T64);
      for (int bx = 0; bx < NB; ++bx) {
        tma_load_4d(&k_map, &kv_bar, sK + bx * BT * SWB, bx * E, kh, k0, b);
        tma_load_4d(&v_map, &kv_bar, sV + bx * BT * SWB, bx * E, kh, k0, b);
      }
      for (int i = 0; i < items; ++i) {
        const int st = i % KV_STAGES;
        mbar_wait(&empty_bar[st], ((i / KV_STAGES) & 1) ^ 1);
        const int h = kh * G + i % G, q0 = item_q0(i);
        mbar_arrive_expect_tx(&full_bar[st], 2 * T64 + 2 * BT * 4);
        uint8_t* sQ = ring + 2 * st * T64;
        for (int bx = 0; bx < NB; ++bx) {
          tma_load_4d(&q_map, &full_bar[st], sQ + bx * BT * SWB, bx * E, h, q0, b);
          tma_load_4d(&do_map, &full_bar[st], sQ + T64 + bx * BT * SWB, bx * E, h, q0, b);
        }
        const int row = (b * H + h) * S + q0;   // rows past S read the next head or zeros
        tma_load_1d(&lse_map, &full_bar[st], sLD + 2 * BT * st, row);
        tma_load_1d(&delta_map, &full_bar[st], sLD + 2 * BT * st + BT, row);
      }
    }
    return;
  }

  // ---- consumer warpgroups: both own the block's 64 keys; item i is
  // consumer i % 2's (and ring stage i % KV_STAGES serves that consumer only)
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = warp / 4 - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int wrow = (t / 32) * 16 + lane / 4;   // this thread's first key row in the tile
  const int kr0 = k0 + wrow, kr1 = kr0 + 8;    // the two keys this thread holds

  float dk[D / 2], dv[D / 2], s[BT / 2], dp[BT / 2];
  uint32_t ph[BT / 16][4], pl[BT / 16][4], sh[BT / 16][4], sl[BT / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);

  mbar_wait(&kv_bar, 0);
  for (int i = cw; i < items; i += 2) {
    const int st = i % KV_STAGES;
    const int q0 = item_q0(i);
    const uint32_t q_addr = smem_u32(ring + 2 * st * T64), do_addr = q_addr + T64;
    const float* sL = sLD + 2 * BT * st;
    const float* sD = sL + BT;
    mbar_wait(&full_bar[st], (i / KV_STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T: keys x q rows, both operands K-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = ((kk * 16) / E) * BT * SWB + ((kk * 16) % E) * 2;
      wgmma_ss<BT>(s, gmma_desc<SWB>(k_addr + off, 16, 8 * SWB),
                   gmma_desc<SWB>(q_addr + off, 16, 8 * SWB), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = ((kk * 16) / E) * BT * SWB + ((kk * 16) % E) * 2;
      wgmma_ss<BT>(dp, gmma_desc<SWB>(v_addr + off, 16, 8 * SWB),
                   gmma_desc<SWB>(do_addr + off, 16, 8 * SWB), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);

    // P^T = exp2(S^T scale - lse) (0 where masked), dS^T = P^T o (dP^T - delta),
    // in place; column c of the accumulator is q row q0 + c
    const bool masked = q0 + BT > S || k0 + BT > S || (causal && k0 + BT - 1 > q0) ||
                        (window > 0 && k0 <= q0 + BT - 1 - window);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * (lane % 4) + (e & 1);
        float p = fast_exp2(s[4 * n + e] * scale_log2 - sL[c]);
        if (masked && !allowed(q0 + c, e < 2 ? kr0 : kr1, S, causal, window)) p = 0.f;
        dp[4 * n + e] = p * (dp[4 * n + e] - sD[c]);
        s[4 * n + e] = p;
      }
    }
    split_bf16(s, ph, pl);
    split_bf16(dp, sh, sl);

    // dV += P^T dO and dK += dS^T Q: A from registers, dO and Q MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint64_t ddo = gmma_desc<SWB>(do_addr + kk * 16 * SWB, BT * SWB, 8 * SWB);
      wgmma_rs_tb<D>(dv, ph[kk], ddo, 1);
      wgmma_rs_tb<D>(dv, pl[kk], ddo, 1);
    }
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint64_t dq_ = gmma_desc<SWB>(q_addr + kk * 16 * SWB, BT * SWB, 8 * SWB);
      wgmma_rs_tb<D>(dk, sh[kk], dq_, 1);
      wgmma_rs_tb<D>(dk, sl[kk], dq_, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dv);
    fence_operands(dk);
    fence_operands(ph);
    fence_operands(pl);
    fence_operands(sh);
    fence_operands(sl);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[st]);
  }

  // ---- epilogue: the consumers swap halves through the ring (stage 0 is
  // consumer 0's and stage 1 consumer 1's, and their loads are all
  // consumed), consumer 0 finishes dK and consumer 1 dV (each c0 + c1),
  // stages it as bf16 in the K or V tile and TMA-stores it; rows past S
  // are dropped
  float* red = reinterpret_cast<float*>(ring);   // 2 x (D/2 x 128) f32, thread-major
  if (cw == 0) {
#pragma unroll
    for (int r = 0; r < D / 2; ++r) red[r * 128 + t] = dv[r];
  } else {
#pragma unroll
    for (int r = 0; r < D / 2; ++r) red[(D / 2 + r) * 128 + t] = dk[r];
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (cw == 0) {
#pragma unroll
    for (int r = 0; r < D / 2; ++r) dk[r] = dk[r] + red[(D / 2 + r) * 128 + t];
    stage_out<D>(dk, scale, sK, BT * SWB, wrow, lane);
  } else {
#pragma unroll
    for (int r = 0; r < D / 2; ++r) dv[r] = red[r * 128 + t] + dv[r];
    stage_out<D>(dv, 1.f, sV, BT * SWB, wrow, lane);
  }
  fence_proxy_async_smem();
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
  if (t == 0) {
    for (int bx = 0; bx < NB; ++bx)
      tma_store_4d(cw == 0 ? &dk_map : &dv_map, (cw == 0 ? sK : sV) + bx * BT * SWB, bx * E, kh,
                   k0, b);
    tma_store_commit_and_wait();
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap dq_map, const float* __restrict__ lse,
                const float* __restrict__ delta, int S, int H, int KH, int causal, int window,
                float scale_log2, float scale) {
  using T = Tile<D>;
  constexpr int SWB = T::SWB, E = T::E, NB = T::NB, T64 = T::T64;
  constexpr int BQ = DQ_ROWS;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[DQ_STAGES], empty_bar[DQ_STAGES], q_bar;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;                 // box b at b * BQ * SWB, rows 0 .. BQ-1
  uint8_t* sdO = sQ + 2 * T64;        // the same for dO
  uint8_t* sKV = sdO + 2 * T64;       // stage s: K at 2s * T64, V after it

  // blocks start in order of blockIdx, x fastest: every (head, batch) of
  // the last, longest causal q tile first
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * BQ;
  const int h = blockIdx.x, b = blockIdx.y, kh = h / (H / KH);
  const int warp = threadIdx.x / 32;

  // KV tiles that intersect the band of this q tile
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int hi = causal ? q_last / BT + 1 : (S + BT - 1) / BT;
  int lo = window > 0 ? max(0, q0 - window + 1) / BT : 0;
  lo = min(lo, max(hi - 1, 0));

  if (threadIdx.x == 0) {
    for (int s = 0; s < DQ_STAGES; ++s) {
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
      mbar_arrive_expect_tx(&q_bar, 4 * T64);
      for (int w = 0; w < 2; ++w)
        for (int bx = 0; bx < NB; ++bx) {
          const int off = bx * BQ * SWB + w * BT * SWB;
          tma_load_4d(&q_map, &q_bar, sQ + off, bx * E, h, q0 + BT * w, b);
          tma_load_4d(&do_map, &q_bar, sdO + off, bx * E, h, q0 + BT * w, b);
        }
      for (int j = lo, i = 0; j < hi; ++j, ++i) {
        const int st = i % DQ_STAGES;
        mbar_wait(&empty_bar[st], ((i / DQ_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full_bar[st], 2 * T64);
        uint8_t* sK = sKV + 2 * st * T64;
        for (int bx = 0; bx < NB; ++bx) {
          tma_load_4d(&k_map, &full_bar[st], sK + bx * BT * SWB, bx * E, kh, j * BT, b);
          tma_load_4d(&v_map, &full_bar[st], sK + T64 + bx * BT * SWB, bx * E, kh, j * BT, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 q rows each
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = warp / 4 - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int wrow = (t / 32) * 16 + lane / 4;   // this thread's first row in the warpgroup
  const int first = q0 + BT * cw;              // the warpgroup's rows: first .. first + 63
  const int last = first + BT - 1;
  const int r0 = first + wrow, r1 = r0 + 8;    // the two rows this thread holds
  const size_t lrow = ((size_t)b * H + h) * S;
  const float l0 = r0 < S ? lse[lrow + r0] : 0.f, l1 = r1 < S ? lse[lrow + r1] : 0.f;
  const float e0 = r0 < S ? delta[lrow + r0] : 0.f, e1 = r1 < S ? delta[lrow + r1] : 0.f;

  // the warpgroup's own tiles [lo_w, hi_w): those that intersect its band
  int lo_w = lo, hi_w = hi;
  if (causal) hi_w = min(hi_w, last / BT + 1);
  if (window > 0) lo_w = max(lo_w, max(0, first - window + 1) / BT);
  if (first >= S) hi_w = lo_w;

  float dq[D / 2], s[BT / 2], dp[BT / 2];
  uint32_t sh[BT / 16][4], sl[BT / 16][4];     // dS as wgmma A fragments, bf16 hi and lo
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const uint32_t q_addr = smem_u32(sQ) + cw * BT * SWB, do_addr = smem_u32(sdO) + cw * BT * SWB;
  auto k_addr = [&](int i) { return smem_u32(sKV + 2 * (i % DQ_STAGES) * T64); };

  // S = Q K^T and dP = dO V^T for the tile in ring slot i (issued, not waited for)
  auto issue_sdp = [&](int i) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = ((kk * 16) % E) * 2, box = (kk * 16) / E;
      wgmma_ss<BT>(s, gmma_desc<SWB>(q_addr + box * BQ * SWB + col, 16, 8 * SWB),
                   gmma_desc<SWB>(k_addr(i) + box * BT * SWB + col, 16, 8 * SWB), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = ((kk * 16) % E) * 2, box = (kk * 16) / E;
      wgmma_ss<BT>(dp, gmma_desc<SWB>(do_addr + box * BQ * SWB + col, 16, 8 * SWB),
                   gmma_desc<SWB>(k_addr(i) + T64 + box * BT * SWB + col, 16, 8 * SWB), kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dS K for the tile in ring slot i, dS = hi + lo (issued, not waited for)
  auto issue_dq = [&](int i) {
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint64_t dk_ = gmma_desc<SWB>(k_addr(i) + kk * 16 * SWB, BT * SWB, 8 * SWB);
      wgmma_rs_tb<D>(dq, sh[kk], dk_, 1);
      wgmma_rs_tb<D>(dq, sl[kk], dk_, 1);
    }
    wgmma_commit();
  };
  // P = exp2(S scale - lse) (0 where masked) and dS = P o (dP - delta) in dp
  auto grad_scores = [&](int k0) {
    const bool masked = k0 + BT > S || last >= S || (causal && k0 + BT - 1 > first) ||
                        (window > 0 && k0 <= last - window);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * n + 2 * (lane % 4) + (e & 1);
        float p = fast_exp2(s[4 * n + e] * scale_log2 - (e < 2 ? l0 : l1));
        if (masked && !allowed(e < 2 ? r0 : r1, kp, S, causal, window)) p = 0.f;
        dp[4 * n + e] = p * (dp[4 * n + e] - (e < 2 ? e0 : e1));
      }
    }
  };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[i % DQ_STAGES]);
  };
  auto wait_full = [&](int i) { mbar_wait(&full_bar[i % DQ_STAGES], (i / DQ_STAGES) & 1); };

  // Ring slot i holds tile lo + i.  Tiles outside [lo_w, hi_w) are waited
  // for and released unread, so that both warpgroups keep the barriers'
  // phases.  Inside, S and dP of tile j are issued together with dQ's
  // product of tile j-1, and dS of tile j is formed while that runs; the
  // fragments it reads are rewritten only after it is waited for.
  mbar_wait(&q_bar, 0);
  int i = 0;
  for (; lo + i < lo_w; ++i) {
    wait_full(i);
    release(i);
  }
  if (lo_w < hi_w) {
    wait_full(i);
    wgmma_fence();
    issue_sdp(i);
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    grad_scores((lo + i) * BT);
    split_bf16(dp, sh, sl);
    for (++i; lo + i < hi_w; ++i) {
      wait_full(i);
      wgmma_fence();
      issue_sdp(i);
      issue_dq(i - 1);
      wgmma_wait<1>();           // S and dP of tile i are done; dQ of tile i-1 may still run
      fence_operands(s);
      fence_operands(dp);
      grad_scores((lo + i) * BT);
      wgmma_wait<0>();
      fence_operands(dq);
      fence_operands(sh);
      fence_operands(sl);
      release(i - 1);
      split_bf16(dp, sh, sl);
    }
    wgmma_fence();
    issue_dq(i - 1);
    wgmma_wait<0>();
    fence_operands(dq);
    fence_operands(sh);
    fence_operands(sl);
    release(i - 1);
  }
  for (; lo + i < hi; ++i) {
    wait_full(i);
    release(i);
  }

  // ---- epilogue: dQ * scale into this warpgroup's Q rows (the same
  // swizzled layout), then one TMA store per box; rows past S are dropped
  uint8_t* sO = sQ + cw * BT * SWB;
  stage_out<D>(dq, scale, sO, BQ * SWB, wrow, lane);
  fence_proxy_async_smem();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  if (t == 0 && first < S) {
    for (int bx = 0; bx < NB; ++bx)
      tma_store_4d(&dq_map, sO + bx * BQ * SWB, bx * E, h, first, b);
    tma_store_commit_and_wait();
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* delta, int B, int S, int H,
           int KH, int causal, int window, cudaStream_t stream) {
  using T = Tile<D>;
  static int kv_done = 0, dq_done = 0;
  cudaError_t err = allow_smem(dkdv_wgmma_kernel<D>, T::KV_SMEM, kv_done);
  if (err == cudaSuccess) err = allow_smem(dq_wgmma_kernel<D>, T::DQ_SMEM, dq_done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm, dom, dqm, dkm, dvm, lm, dlm;
  const long rows = (long)B * H * S;
  if (!encode_bf16_4d<T::SWB>(&qm, q, D, H, S, B, BT) ||
      !encode_bf16_4d<T::SWB>(&km, k, D, KH, S, B, BT) ||
      !encode_bf16_4d<T::SWB>(&vm, v, D, KH, S, B, BT) ||
      !encode_bf16_4d<T::SWB>(&dom, dout, D, H, S, B, BT) ||
      !encode_bf16_4d<T::SWB>(&dqm, dq, D, H, S, B, BT) ||
      !encode_bf16_4d<T::SWB>(&dkm, dk, D, KH, S, B, BT) ||
      !encode_bf16_4d<T::SWB>(&dvm, dv, D, KH, S, B, BT) ||
      !encode_f32_1d(&lm, lse, rows, BT) || !encode_f32_1d(&dlm, delta, rows, BT))
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  int e = launch_delta<__nv_bfloat16, D>(o, dout, delta, B, S, H, stream);
  if (e) return e;
  dkdv_wgmma_kernel<D><<<dim3(KH, B, (S + BT - 1) / BT), THREADS, T::KV_SMEM, stream>>>(
      qm, km, vm, dom, dkm, dvm, lm, dlm, S, H, KH, causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_wgmma_kernel<D><<<dim3(H, B, (S + DQ_ROWS - 1) / DQ_ROWS), THREADS, T::DQ_SMEM, stream>>>(
      qm, km, vm, dom, dqm, lse, delta, S, H, KH, causal, window, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

int dispatch_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, void* dq, void* dk, void* dv, float* delta, int B, int S,
                 int H, int KH, int D, int causal, int window, cudaStream_t st) {
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v;
  const float *fo = (const float*)o, *fd = (const float*)dout;
  float *gq = (float*)dq, *gk = (float*)dk, *gv = (float*)dv;
  switch (D) {
    case 16: return launch_f32<16>(fq, fk, fv, fo, fd, lse, gq, gk, gv, delta, B, S, H, KH, causal, window, st);
    case 32: return launch_f32<32>(fq, fk, fv, fo, fd, lse, gq, gk, gv, delta, B, S, H, KH, causal, window, st);
    case 64: return launch_f32<64>(fq, fk, fv, fo, fd, lse, gq, gk, gv, delta, B, S, H, KH, causal, window, st);
    case 80: return launch_f32<80>(fq, fk, fv, fo, fd, lse, gq, gk, gv, delta, B, S, H, KH, causal, window, st);
    case 128: return launch_f32<128>(fq, fk, fv, fo, fd, lse, gq, gk, gv, delta, B, S, H, KH, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, void* dq, void* dk, void* dv, float* delta, int B, int S,
                  int H, int KH, int D, int causal, int window, cudaStream_t st) {
  switch (D) {
    case 16: return wg::launch<16>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, S, H, KH, causal, window, st);
    case 32: return wg::launch<32>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, S, H, KH, causal, window, st);
    case 64: return wg::launch<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, S, H, KH, causal, window, st);
    case 80: return wg::launch<80>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, S, H, KH, causal, window, st);
    case 128: return wg::launch<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, S, H, KH, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// window <= 0 means no window.  lse is the forward kernel's f32 (B,H,S)
// log2-domain log-sum-exp of the rows; delta is f32 (B,H,S) scratch.
// Three launches on `stream`; returns the first nonzero cudaGetLastError()
// after a launch (or a refused tensor map), else 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* dk,
                                   void* dv, void* delta, int B, int S, int H, int KH, int D,
                                   int causal, int window, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  if (dtype == DTYPE_F32)
    return dispatch_f32(q, k, v, o, dout, l, dq, dk, dv, dl, B, S, H, KH, D, causal, window, st);
  if (dtype == DTYPE_BF16)
    return dispatch_bf16(q, k, v, o, dout, l, dq, dk, dv, dl, B, S, H, KH, D, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
