// Flash attention backward for Hopper (sm_90a): the gradient of causal
// and/or sliding-window GQA/MQA attention over q (B,S,H,D) and k, v
// (B,S,K,D), f32 or bf16, given the forward's output o and its gradient dO.
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
// bound.  This first version is the simple one: f32 FMA on the CUDA cores
// (67 TFLOP/s at most, a fifteenth of the bf16 tensor-core rate), tiles
// staged in shared memory as f32, and it recomputes the scores in each of
// its three passes (eight products, not five).  It keeps every
// intermediate (P, dS) on chip, skips tiles outside the causal or window
// band as the forward does, and uses no atomics.  Three launches:
//
// 1. lse_delta_kernel, one block per (batch, head, 64-row q tile): each
//    row's log-sum-exp of the masked, scaled scores (recomputed with the
//    online max, as the forward; the forward kernel stays as it is and
//    writes no LSE) and delta = rowsum(dO o O), into f32 scratch (B,H,S).
// 2. dkdv_kernel, one block per (batch, KV head, 64-key tile): K and V
//    stay in shared memory while the block loops over the group's query
//    heads and the q tiles in the band, so the sum over the group stays in
//    registers (no atomics, no second reduction pass).  Per q tile:
//    S = Q K^T and dP = dO V^T (a 4x4 block of each per thread), then
//    P = exp(S - lse) and dS = P (dP - delta) into shared memory, then
//    dV += P^T dO and dK += dS^T Q.
// 3. dq_kernel, one block per (batch, head, 64-row q tile): loops over the
//    KV tiles in the band, S and dP as above, dS into shared memory,
//    dQ += dS K.
//
// Thread map (256 threads), as the forward's f32 kernel: lane group
// ty = tid/16 owns rows 4ty..4ty+3 of a 64-row tile, lane tx = tid%16 owns
// score columns tx+16j and output columns tx+16c.  Tiles are padded to
// D+1 and 65 floats a row, so the column reads of the products are free of
// bank conflicts.  Shared memory at head_dim 128: 166 KB (dkdv), 149 KB
// (dq), 66 KB (lse).  Masked scores are never exponentiated: P is 0 where
// the mask forbids, so no sentinel reaches the gradient.

#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BT = 64;        // rows of a q tile and of a KV tile
constexpr int THREADS = 256;  // 16 lane groups x 16 lanes
constexpr int PP = BT + 1;    // pitch of the P / dS tiles

__device__ __forceinline__ bool allowed(int qp, int kp, int S, int causal, int window) {
  bool ok = qp < S && kp < S;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// rows r0 .. r0+63 of head hh of a (B,S,NH,D) tensor into a f32 tile of
// pitch D+1; rows past S are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b, int r0,
                                          int hh, int S, int NH) {
  for (int i = threadIdx.x; i < BT * D; i += THREADS) {
    const int r = i / D, d = i % D, s = r0 + r;
    dst[r * (D + 1) + d] = s < S ? to_f32(src[((size_t)(b * S + s) * NH + hh) * D + d]) : 0.f;
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
constexpr int lse_smem_bytes() { return 2 * BT * (D + 1) * 4; }
template <int D>
constexpr int dkdv_smem_bytes() { return (4 * BT * (D + 1) + 2 * BT * PP + 2 * BT) * 4; }
template <int D>
constexpr int dq_smem_bytes() { return (4 * BT * (D + 1) + BT * PP) * 4; }

// ---- 1. lse and delta per row
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
lse_delta_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
                 const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
                 int S, int H, int KH, int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;           // BT x DP
  float* sK = sQ + BT * DP;   // BT x DP
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, kh = h / (H / KH);

  // delta = rowsum(dO o O), straight from device memory
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    float acc = 0.f;
    if (s < S) {
      const size_t row = ((size_t)(b * S + s) * H + h) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        acc = fmaf(to_f32(dout[row + tx + 16 * c]), to_f32(o[row + tx + 16 * c]), acc);
    }
    acc = group_sum<16>(acc);
    if (tx == 0 && s < S) delta[((size_t)b * H + h) * S + s] = acc;
  }

  load_tile<T, D>(sQ, q, b, q0, h, S, H);
  int lo, hi;
  kv_range(q0, S, causal, window, lo, hi);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BT;
    __syncthreads();  // Q visible; the previous tile's readers done
    load_tile<T, D>(sK, k, b, k0, kh, S, KH);
    __syncthreads();
    float sc[4][4];
    block_abt<D>(sc, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        sc[i][jj] = allowed(qp, k0 + tx + 16 * jj, S, causal, window) ? sc[i][jj] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][jj]);
      }
      mx = group_max<16>(mx);
      // a row with nothing allowed so far keeps m = -1e30, and its junk sum
      // is wiped by the correction exp(-1e30 - m) = 0 at its first real score
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) rs += expf(sc[i][jj] - m_new);
      rs = group_sum<16>(rs);
      l[i] = l[i] * expf(m[i] - m_new) + rs;
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (tx == 0 && s < S) lse[((size_t)b * H + h) * S + s] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---- 2. dK and dV per KV tile, summed over the group's heads in registers
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
            int H, int KH, int causal, int window, float scale) {
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

  load_tile<T, D>(sK, k, b, k0, kh, S, KH);
  load_tile<T, D>(sV, v, b, k0, kh, S, KH);

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

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int qt = qlo; qt < qhi; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // K, V visible; the previous tile's readers done
      load_tile<T, D>(sQ, q, b, q0, h, S, H);
      load_tile<T, D>(sO, dout, b, q0, h, S, H);
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
                              ? expf(sc[i][jj] * scale - sL[r]) : 0.f;
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
      dk[row + tx + 16 * c] = from_f32<T>(ak[i][c] * scale);
      dv[row + tx + 16 * c] = from_f32<T>(av[i][c]);
    }
  }
}

// ---- 3. dQ per q tile
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int S, int H, int KH,
          int causal, int window, float scale) {
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

  load_tile<T, D>(sQ, q, b, q0, h, S, H);
  load_tile<T, D>(sO, dout, b, q0, h, S, H);
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
    load_tile<T, D>(sK, k, b, k0, kh, S, KH);
    load_tile<T, D>(sV, v, b, k0, kh, S, KH);
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
                            ? expf(sc[i][jj] * scale - rl[i]) : 0.f;
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
    for (int c = 0; c < DC; ++c) dq[row + tx + 16 * c] = from_f32<T>(aq[i][c] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* delta, int B, int S, int H, int KH,
           int causal, int window, cudaStream_t stream) {
  static int lse_done = 0, dkdv_done = 0, dq_done = 0;
  cudaError_t err = allow_smem(lse_delta_kernel<T, D>, lse_smem_bytes<D>(), lse_done);
  if (err == cudaSuccess) err = allow_smem(dkdv_kernel<T, D>, dkdv_smem_bytes<D>(), dkdv_done);
  if (err == cudaSuccess) err = allow_smem(dq_kernel<T, D>, dq_smem_bytes<D>(), dq_done);
  if (err != cudaSuccess) return (int)err;
  const int nt = (S + BT - 1) / BT;
  const float scale = (float)(1.0 / sqrt((double)D));
  const T* tq = (const T*)q;
  const T* tk = (const T*)k;
  const T* tv = (const T*)v;
  const T* tdo = (const T*)dout;
  lse_delta_kernel<T, D><<<dim3(nt, H, B), THREADS, lse_smem_bytes<D>(), stream>>>(
      tq, tk, (const T*)o, tdo, lse, delta, S, H, KH, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T, D><<<dim3(nt, KH, B), THREADS, dkdv_smem_bytes<D>(), stream>>>(
      tq, tk, tv, tdo, lse, delta, (T*)dk, (T*)dv, S, H, KH, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, D><<<dim3(nt, H, B), THREADS, dq_smem_bytes<D>(), stream>>>(
      tq, tk, tv, tdo, lse, delta, (T*)dq, S, H, KH, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* o, const void* dout,
               void* dq, void* dk, void* dv, float* lse, float* delta, int B, int S, int H,
               int KH, int D, int causal, int window, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H, KH, causal, window, st);
    case 32: return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H, KH, causal, window, st);
    case 64: return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H, KH, causal, window, st);
    case 80: return launch<T, 80>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H, KH, causal, window, st);
    case 128: return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H, KH, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// window <= 0 means no window.  lse and delta are f32 scratch of B*H*S
// floats each.  Three launches on `stream`; returns the first nonzero
// cudaGetLastError() after a launch, else 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* lse,
                                   void* delta, int B, int S, int H, int KH, int D, int causal,
                                   int window, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  float* dl = (float*)delta;
  if (dtype == DTYPE_F32)
    return dispatch_d<float>(q, k, v, o, dout, dq, dk, dv, l, dl, B, S, H, KH, D, causal, window, st);
  if (dtype == DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, dl, B, S, H, KH, D, causal,
                                     window, st);
  return (int)cudaErrorInvalidValue;
}
