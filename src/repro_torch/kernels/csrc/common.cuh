// Shared helpers for the hand-written kernels: dtype conversion to and from
// the f32 working type, 16-lane / 32-lane reductions, and the scans'
// backward kernels' row and column sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Masked scores are -1e30, never -inf: a tile whose entries are all masked
// for a row gives exp(-1e30 - -1e30) = 1, and the later correction
// exp(m_prev - m_new) = 0 wipes that junk.  With -inf the same tile gives
// NaN.  (The reference kernels use the same sentinel.)
constexpr float NEG_INF = -1e30f;

// dtype codes passed from Python: 0 = float32, 1 = bfloat16
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Reductions over aligned groups of `width` lanes (width a power of two ≤ 32).
template <int width>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int width>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The two scans' backward kernels hold a 64 × 64 state as 4 × 4 a thread:
// the 16 lanes of a half-warp share four rows, the two half-warps the
// same four columns.  row_sum16: v[a] is the lane's partial sum of row a of
// its four; returns the half-warp's whole sum of row 2·(lane&1) +
// ((lane>>1)&1), each level keeping half the rows and sending the other
// half (5 shuffles for 4 rows).
__device__ __forceinline__ float row_sum16(const float v[4], int lane) {
  const bool b0 = lane & 1, b1 = lane & 2;
  float k0 = b0 ? v[2] : v[0], k1 = b0 ? v[3] : v[1];
  const float s0 = b0 ? v[0] : v[2], s1 = b0 ? v[1] : v[3];
  k0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  k1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  float kk = b1 ? k1 : k0;
  const float s = b1 ? k0 : k1;
  kk += __shfl_xor_sync(0xffffffffu, s, 2);
  kk += __shfl_xor_sync(0xffffffffu, kk, 4);
  kk += __shfl_xor_sync(0xffffffffu, kk, 8);
  return kk;
}

// col_sum2: c[x] is the lane's partial sum of column x of its four over its
// rows; returns the warp's sums of columns 2·hi and 2·hi + 1 (hi = lane >= 16).
__device__ __forceinline__ float2 col_sum2(const float c[4], int lane) {
  const bool hi = lane & 16;
  float k0 = hi ? c[2] : c[0], k1 = hi ? c[3] : c[1];
  const float s0 = hi ? c[0] : c[2], s1 = hi ? c[1] : c[3];
  k0 += __shfl_xor_sync(0xffffffffu, s0, 16);
  k1 += __shfl_xor_sync(0xffffffffu, s1, 16);
  return make_float2(k0, k1);
}

// The scans' backward kernels' carry across segments, for one state entry:
// fwd[j] holds segment j's contribution to the state from a zero start and
// bwd[j] its contribution to the gradient carried into segment j - 1 (each
// `stride` floats after the last); dec[j] (`dstride` apart) the segment's
// total decay.  Overwrites fwd[j] with the state entering segment j (0,
// then x ← dec[j]·x + fwd[j]) and bwd[j] with the gradient entering
// segment j from the later ones (0 for the last, then backwards), in
// order, so two calls give the same bits.
__device__ __forceinline__ void carry_entry(float* __restrict__ fwd, float* __restrict__ bwd,
                                            const float* __restrict__ dec, int nseg,
                                            size_t stride, size_t dstride) {
  float x = 0.f;
  for (int j = 0; j < nseg; ++j) {
    const float part = fwd[j * stride];
    fwd[j * stride] = x;
    x = fmaf(dec[j * dstride], x, part);
  }
  x = 0.f;
  for (int j = nseg - 1; j >= 0; --j) {
    const float part = bwd[j * stride];
    bwd[j * stride] = x;
    x = fmaf(dec[j * dstride], x, part);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Opt a kernel into more than 48 KB of dynamic shared memory (once per
// instantiation; a refused attribute is returned as the launch error).
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, int bytes, int& done_bytes) {
  if (bytes <= 48 * 1024 || bytes <= done_bytes) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done_bytes = bytes;
  return err;
}

}  // namespace repro_torch
