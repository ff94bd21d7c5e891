// Shared helpers for the hand-written attention kernels: dtype conversion
// to and from the f32 working type, and 16-lane / 32-lane reductions.
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
