// Single-token decode attention for Hopper (sm_90a): one query token per
// sequence, q (B,H,D), over a ring-buffer KV cache (B,C,K,D), f32 or bf16.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention_fwd
// (body `_kernel`), which computes the same function as the model's decode
// attention (repro/models/attention.py::decode_attention_block).  A slot is
// valid when positions[slot] >= 0, positions[slot] <= next_pos and (with a
// window) positions[slot] > next_pos - window.  Scores are scaled in f32,
// masked scores are -1e30, (m, l, acc) are f32, output is in q's dtype.
//
// What bounds it on the H100: each cache element is read once for a handful
// of multiply-adds (G = H/K per K element), far below ~295 operations per
// byte, so the bound is the memory rate.  The design moves each byte once:
// a block owns one (batch, KV head), and the G query heads of the group
// share every K/V tile it stages through shared memory.  positions and
// next_pos are read from device memory, so a decode step needs no host
// synchronisation.  One block per (batch, KV head) would fill few of the
// 132 SMs at a small batch (32 at qwen3-4b's batch 4), so the cache tiles
// are split over a third grid axis (flash-decode): each block runs the
// online softmax over its share of tiles and writes f32 (m, l, acc), and a
// second small kernel combines the splits with weights exp(m_s - max m).
// A split whose slots are all masked keeps m = -1e30 and gets weight 0, as
// a masked tile does inside one block.  Any C is taken: the ragged last
// tile is masked.

#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BK = 64;         // cache slots per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

constexpr int COMBINE_THREADS = 128;

inline int decode_smem_bytes(int G, int D) {
  // q, K (rows padded to D+1), V, P (rows padded to BK+1), acc, m, l, corr
  return (G * D + BK * (D + 1) + BK * D + G * (BK + 1) + G * D + 3 * G) * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_fwd_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const int* __restrict__ positions,
                  const int* __restrict__ next_pos, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int C, int H, int KH, int D,
                  int window, float scale, int tiles_per_split) {
  const int G = H / KH;
  const int DP = D + 1;
  const int PP = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;              // G x D
  float* sK = sQ + G * D;        // BK x DP
  float* sV = sK + BK * DP;      // BK x D
  float* sP = sV + BK * D;       // G x PP
  float* sAcc = sP + G * PP;     // G x D
  float* sM = sAcc + G * D;      // G
  float* sL = sM + G;            // G
  float* sCorr = sL + G;         // G

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int qp = *next_pos;
  const T* qrow = q + ((size_t)b * H + (size_t)kh * G) * D;  // G heads, contiguous

  for (int i = tid; i < G * D; i += THREADS) {
    sQ[i] = to_f32(qrow[i]);
    sAcc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    sM[g] = NEG_INF;
    sL[g] = 0.f;
  }

  const int c_end = min(C, (split + 1) * tiles_per_split * BK);
  for (int c0 = split * tiles_per_split * BK; c0 < c_end; c0 += BK) {
    __syncthreads();  // init visible; previous tile's readers done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D, slot = c0 + r;
      const size_t off = (((size_t)b * C + slot) * KH + kh) * D + d;
      sK[r * DP + d] = slot < C ? to_f32(kc[off]) : 0.f;
      sV[r * D + d] = slot < C ? to_f32(vc[off]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < G * BK; i += THREADS) {
      const int g = i / BK, c = i % BK, slot = c0 + c;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(sQ[g * D + d], sK[c * DP + d], s);
      const int kp = slot < C ? positions[slot] : -1;
      bool ok = kp >= 0 && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      sP[g * PP + c] = ok ? s * scale : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {
      float* prow = sP + g * PP;
      const float x0 = prow[lane], x1 = prow[lane + 32];
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, group_max<32>(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      prow[lane] = p0;
      prow[lane + 32] = p1;
      const float rs = group_sum<32>(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sM[g] = m_new;
        sL[g] = sL[g] * corr + rs;
        sCorr[g] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      const float* prow = sP + g * PP;
      float a = sAcc[i] * sCorr[g];
      for (int c = 0; c < BK; ++c) a = fmaf(prow[c], sV[c * D + d], a);
      sAcc[i] = a;
    }
  }
  __syncthreads();

  // partials of this (batch, KV head, split): acc (G x D), then (m, l) per g
  const size_t part = ((size_t)b * KH + kh) * gridDim.z + split;
  for (int i = tid; i < G * D; i += THREADS) part_acc[part * G * D + i] = sAcc[i];
  for (int g = tid; g < G; g += THREADS) {
    part_ml[(part * G + g) * 2] = sM[g];
    part_ml[(part * G + g) * 2 + 1] = sL[g];
  }
}

// out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30), w_s = exp(m_s - max_s m_s)
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, T* __restrict__ o,
                      int H, int KH, int D, int splits) {
  const int G = H / KH;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const size_t part0 = ((size_t)b * KH + kh) * splits;
  T* orow = o + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += COMBINE_THREADS) {
    const int g = i / D;
    float m_max = NEG_INF;
    for (int s = 0; s < splits; ++s)
      m_max = fmaxf(m_max, part_ml[((part0 + s) * G + g) * 2]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(part_ml[((part0 + s) * G + g) * 2] - m_max);
      l += w * part_ml[((part0 + s) * G + g) * 2 + 1];
      acc += w * part_acc[(part0 + s) * G * D + i];
    }
    orow[i] = from_f32<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const int* positions,
           const int* next_pos, void* o, float* part_acc, float* part_ml, int B,
           int C, int H, int KH, int D, int window, int splits,
           cudaStream_t stream) {
  static int smem_done = 0;
  const int smem = decode_smem_bytes(H / KH, D);
  cudaError_t err = allow_smem(decode_fwd_kernel<T>, smem, smem_done);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (C + BK - 1) / BK;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  // every split must own at least one tile
  if ((splits - 1) * tiles_per_split >= tiles) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  decode_fwd_kernel<T><<<dim3(KH, B, splits), THREADS, smem, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, positions, next_pos, part_acc,
      part_ml, C, H, KH, D, window, scale, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<dim3(KH, B), COMBINE_THREADS, 0, stream>>>(
      part_acc, part_ml, (T*)o, H, KH, D, splits);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// positions: int32 (C,) on the device; next_pos: one int32 on the device.
// part_acc: f32 scratch of B*KH*splits*H/KH*D, part_ml: of B*KH*splits*H/KH*2.
// window <= 0 means no window.  Returns cudaGetLastError() after the launches.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache, const void* positions,
                                    const void* next_pos, void* o, void* part_acc,
                                    void* part_ml, int B, int C, int H, int KH,
                                    int D, int window, int splits, int dtype,
                                    void* stream) {
  using namespace repro_torch;
  if (B <= 0 || C <= 0 || KH <= 0 || H % KH || D <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* pos = (const int*)positions;
  const int* npos = (const int*)next_pos;
  float* pacc = (float*)part_acc;
  float* pml = (float*)part_ml;
  if (dtype == DTYPE_F32)
    return launch<float>(q, k_cache, v_cache, pos, npos, o, pacc, pml, B, C, H, KH, D,
                         window, splits, st);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, pos, npos, o, pacc, pml, B, C, H,
                                 KH, D, window, splits, st);
  return (int)cudaErrorInvalidValue;
}
