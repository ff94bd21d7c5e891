// Flash attention forward for Hopper (sm_90a): causal and/or sliding-window
// GQA/MQA attention over q (B,S,H,D) and k, v (B,S,K,D), f32 or bf16.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_fwd
// (body `_kernel`).  Same function: scores are scaled in f32, masked scores
// are -1e30, the online softmax keeps (m, l, acc) in f32 across KV tiles,
// and the output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: causal prefill at the model's shapes does
// ~S/2 multiply-adds per q element read, far above the card's ~295 bf16
// operations per byte, so the bound is the tensor-core rate.  This first
// version does its two products with f32 FMAs on the CUDA cores (no wgmma,
// no TMA), so it runs well below that bound; what the design does about
// the bound is to keep every intermediate on chip: a block owns one
// (batch, head, 64-row q tile), stages K and V tiles through shared memory,
// holds the running max, sum and output rows in registers, and skips KV
// tiles that lie wholly outside the causal or window band (the TPU kernel
// visits them masked; the result is the same).  Any S is taken: the ragged
// last q and KV tiles are masked here.
//
// Thread map (256 threads): lane group ty = tid/16 owns q rows 4ty..4ty+3;
// lane tx = tid%16 owns score columns tx+16j and output columns tx+16c.
// Row reductions are 16-lane shuffles inside one half-warp.

#include <math.h>

#include "common.cuh"

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
  if (dtype == DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, H, KH, D, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
