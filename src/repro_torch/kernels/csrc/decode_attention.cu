// Single-token decode attention for Hopper (sm_90a): one query token per
// sequence, q (B,H,D), over a ring-buffer KV cache (B,C,K,D), f32 or bf16.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention_fwd
// (body `_kernel`), which computes the same function as the model's decode
// attention (repro/models/attention.py::decode_attention_block).  A slot is
// valid when positions[slot] >= 0, positions[slot] <= next_pos and (with a
// window) positions[slot] > next_pos - window.  Scores are scaled in f32,
// masked scores are -1e30, (m, l, acc) are f32, output is in q's dtype.
// positions and next_pos are read from device memory, so a decode step
// needs no host synchronisation.  Any C is taken: the ragged last tile is
// masked.
//
// What bounds it on the H100: each cache element is read once for G = H/K
// multiply-adds, far below ~295 operations per byte, so the bound is the
// memory rate, and the design is about bytes in flight:
// - A block owns one (batch, KV head, group of GB query heads, split of the
//   cache).  The GB heads share every K/V tile (GB = G up to 8; a larger
//   or odd G takes several head groups, each reading the cache again).
// - Tiles of 64 slots stay in their storage dtype in shared memory and are
//   filled by 16-byte cp.async into a ring of STAGES buffers (3, or 2 where
//   three would pass ~96 KB), so the next tiles' loads are in flight while
//   the current one is scored.  Slots past C are zero-filled.  (At
//   zamba2-2.7b's head_dim 80 a fourth stage measured slower.)
// - Each of the 8 warps owns 8 slots of every tile and runs its own
//   online softmax over them, with no block barrier but the ring's: LG
//   lanes (a power of two covering D in 16-byte chunks) hold one slot's
//   row, each lane one chunk of q and of the output, and a dot product is a
//   log2(LG)-step shuffle reduction.
// - The splits of one (batch, KV head, head group) form a thread-block
//   cluster.  Each block merges its warps' (m, l, acc) in shared memory;
//   then every block reads all the splits' partials through distributed
//   shared memory and writes its share of the outputs, with weights
//   exp(m_s - max m).  A split whose slots are all masked keeps m = -1e30
//   and gets weight 0.  So one launch does the whole step and the wrapper
//   allocates nothing but the output.
// - The wrapper (decode_attention.py::splits_for) chooses the splits: at
//   most two blocks per SM and 8, the portable cluster size, halved until
//   every cluster runs at once (decode_attention_clusters asks the
//   occupancy API; a cluster's blocks share a GPC: on the H100 30 clusters
//   of 8 fit, fewer than the 32 that 8 splits need at qwen3-4b's batch 4).
//   So qwen3-4b at batch 4 (8 KV heads, 16 tiles) runs 4 splits of 4
//   tiles, 128 blocks, and zamba2-2.7b (32 KV heads) 2 splits of 8 tiles,
//   256 blocks; at batch 1 the cap leaves qwen3-4b 64 blocks, so half the
//   SMs stay idle.
// - On request (a non-null `lse`) the merge also writes each row's
//   log-sum-exp of the allowed scaled scores, natural log, f32 (B,H): the
//   thread that writes a head's element 0 writes it.  A row with no
//   allowed slot gets -inf, so a caller merging partials over slot ranges
//   (tensor-parallel decode) weighs it 0.  Without the request nothing
//   else changes.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {
namespace {

constexpr int BK = 64;           // cache slots per tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int WARP_SLOTS = BK / WARPS;
constexpr int MAX_SPLITS = 8;    // portable cluster size

template <typename T, int D>
struct Cfg {
  static constexpr int CE = 16 / sizeof(T);          // elements per 16-byte chunk
  static constexpr int NCH = D / CE;                 // chunks per cache row
  static constexpr int LG = NCH <= 4 ? 4 : NCH <= 8 ? 8 : NCH <= 16 ? 16 : 32;  // >= 32 / WARP_SLOTS
  static constexpr int SPP = 32 / LG;                // slots per warp pass
  static constexpr int PASSES = WARP_SLOTS / SPP;
  static constexpr int TILE_BYTES = BK * D * (int)sizeof(T);   // one K or V tile
  static constexpr int STAGES_FIT = 98304 / (2 * TILE_BYTES);
  static constexpr int STAGES = STAGES_FIT < 2 ? 2 : STAGES_FIT > 3 ? 3 : STAGES_FIT;
  static_assert(NCH * CE == D && NCH <= 32, "head_dim must be a multiple of one chunk");
};

template <typename T, int D, int GB>
constexpr int decode_smem_bytes() {
  using C = Cfg<T, D>;
  // the ring; after the last tile it holds each warp's partial (acc, m, l)
  // and the block's
  constexpr int ring = C::STAGES * 2 * C::TILE_BYTES;
  constexpr int partials = (WARPS + 1) * GB * (D + 2) * 4;
  return ring > partials ? ring : partials;
}

template <typename T>
__device__ __forceinline__ void chunk_to_f32(const T* p, float* out);
template <>
__device__ __forceinline__ void chunk_to_f32<float>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
template <>
__device__ __forceinline__ void chunk_to_f32<__nv_bfloat16>(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}

// max over the lanes that hold the same chunk in the warp's lane groups
template <int LG>
__device__ __forceinline__ float across_groups_max(float x) {
#pragma unroll
  for (int off = LG; off < 32; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
template <int LG>
__device__ __forceinline__ float across_groups_sum(float x) {
#pragma unroll
  for (int off = LG; off < 32; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D, int GB>
__global__ void __launch_bounds__(THREADS)
decode_fwd_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                  const int* __restrict__ positions, const int* __restrict__ next_pos,
                  T* __restrict__ o, float* __restrict__ lse, int C, int H, int KH,
                  int window, float scale, int tiles_per_split) {
  using Cf = Cfg<T, D>;
  constexpr int CE = Cf::CE, NCH = Cf::NCH, LG = Cf::LG, SPP = Cf::SPP, PASSES = Cf::PASSES;
  constexpr int STAGES = Cf::STAGES;
  extern __shared__ __align__(16) uint8_t smem[];
  T* ring = reinterpret_cast<T*>(smem);              // stage s: K, then V
  float* wpart = reinterpret_cast<float*>(smem);     // after the loop: [WARPS][GB][D+2]
  float* bpart = wpart + WARPS * GB * (D + 2);       // and [GB][D+2]: acc, m, l

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, splits = gridDim.x;
  const int G = H / KH;
  const int groups = G / GB;
  const int kh = blockIdx.y / groups, g0 = kh * G + (blockIdx.y % groups) * GB;  // first head
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ch = lane % LG;                 // this lane's chunk of a row
  const bool has_ch = ch < NCH;
  const int qp = *next_pos;

  const int tiles = (C + BK - 1) / BK;
  const int t_begin = split * tiles_per_split;
  const int n_tiles = max(0, min(tiles, t_begin + tiles_per_split) - t_begin);

  auto load_tile = [&](int t, int stage) {
    T* sk = ring + (size_t)stage * 2 * BK * D;
    T* sv = sk + BK * D;
    const int c0 = (t_begin + t) * BK;
    for (int i = tid; i < BK * NCH; i += THREADS) {
      const int r = i / NCH, c = i % NCH, slot = c0 + r;
      const size_t off = (((size_t)b * C + min(slot, C - 1)) * KH + kh) * D + c * CE;
      const int bytes = slot < C ? 16 : 0;
      cp_async_16(sk + r * D + c * CE, kc + off, bytes);
      cp_async_16(sv + r * D + c * CE, vc + off, bytes);
    }
  };

  // this lane's chunk of q for each head, and its running state
  float qv[GB][CE], acc[GB][CE], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (has_ch) {
      chunk_to_f32<T>(q + ((size_t)b * H + g0 + g) * D + ch * CE, qv[g]);
    } else {
#pragma unroll
      for (int e = 0; e < CE; ++e) qv[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < CE; ++e) acc[g][e] = 0.f;
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile t visible to all; tile t-1's stage free
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();

    const T* sk = ring + (size_t)(t % STAGES) * 2 * BK * D;
    const T* sv = sk + BK * D;
    const int c0 = (t_begin + t) * BK;
    float sc[PASSES][GB];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = warp * WARP_SLOTS + p * SPP + lane / LG;   // this lane group's slot
      float kv[CE];
      if (has_ch) {
        chunk_to_f32<T>(sk + r * D + ch * CE, kv);
      } else {
#pragma unroll
        for (int e = 0; e < CE; ++e) kv[e] = 0.f;
      }
      const int slot = c0 + r;
      const int kp = slot < C ? __ldg(positions + slot) : -1;
      bool ok = kp >= 0 && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < CE; ++e) x = fmaf(qv[g][e], kv[e], x);
        x = group_sum<LG>(x);
        sc[p][g] = ok ? x * scale : NEG_INF;
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = NEG_INF;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) mx = fmaxf(mx, sc[p][g]);
      const float m_new = fmaxf(m[g], across_groups_max<LG>(mx));
      const float corr = expf(m[g] - m_new);
      m[g] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        sc[p][g] = expf(sc[p][g] - m_new);
        rs += sc[p][g];
      }
      l[g] = l[g] * corr + rs;   // this lane group's slots; summed over groups at the end
#pragma unroll
      for (int e = 0; e < CE; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = warp * WARP_SLOTS + p * SPP + lane / LG;
      float vv[CE];
      if (has_ch) {
        chunk_to_f32<T>(sv + r * D + ch * CE, vv);
      } else {
#pragma unroll
        for (int e = 0; e < CE; ++e) vv[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < CE; ++e) acc[g][e] = fmaf(sc[p][g], vv[e], acc[g][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp done with the ring, which now takes the partials

  // ---- this warp's partial: sum the lane groups (m is warp-uniform)
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    l[g] = across_groups_sum<LG>(l[g]);
#pragma unroll
    for (int e = 0; e < CE; ++e) acc[g][e] = across_groups_sum<LG>(acc[g][e]);
    float* wp = wpart + (warp * GB + g) * (D + 2);
    if (lane < LG && has_ch) {
#pragma unroll
      for (int e = 0; e < CE; ++e) wp[ch * CE + e] = acc[g][e];
    }
    if (lane == 0) {
      wp[D] = m[g];
      wp[D + 1] = l[g];
    }
  }
  __syncthreads();

  // ---- the block's partial: merge the warps
  for (int i = tid; i < GB * (D + 1); i += THREADS) {
    const int g = i / (D + 1), d = i % (D + 1);   // d == D: the (m, l) pair
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wpart[(w * GB + g) * (D + 2) + D]);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* wp = wpart + (w * GB + g) * (D + 2);
      s += expf(wp[D] - mx) * wp[d < D ? d : D + 1];
    }
    float* bp = bpart + g * (D + 2);
    if (d < D) {
      bp[d] = s;
    } else {
      bp[D] = mx;
      bp[D + 1] = s;
    }
  }

  // ---- the cluster: merge the splits through distributed shared memory
  cluster.sync();
  const int per = (GB * D + splits - 1) / splits;
  const int i_end = min(GB * D, (split + 1) * per);
  for (int i = split * per + tid; i < i_end; i += THREADS) {
    const int g = i / D, d = i % D;
    // all remote reads issued before any is used (unrolled to the cap)
    float ms[MAX_SPLITS], ls[MAX_SPLITS], as[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < splits) {
        const float* bp = cluster.map_shared_rank(bpart, s) + g * (D + 2);
        ms[s] = bp[D], ls[s] = bp[D + 1], as[s] = bp[d];
      } else {
        ms[s] = NEG_INF, ls[s] = 0.f, as[s] = 0.f;
      }
    }
    float mx = NEG_INF;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) mx = fmaxf(mx, ms[s]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      const float w = s < splits ? expf(ms[s] - mx) : 0.f;
      num += w * as[s];
      den += w * ls[s];
    }
    o[((size_t)b * H + g0 + g) * D + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
    if (lse != nullptr && d == 0) {
      // masked scores are exactly NEG_INF: a row with none allowed keeps it
      lse[(size_t)b * H + g0 + g] = mx > 0.5f * NEG_INF ? mx + logf(den) : -INFINITY;
    }
  }
  cluster.sync();   // no block leaves while another still reads its partial
}

template <typename T, int D, int GB>
cudaError_t allow_decode_smem() {
  static int done = 0;
  return allow_smem(decode_fwd_kernel<T, D, GB>, decode_smem_bytes<T, D, GB>(), done);
}

// The clusters of `splits` blocks a launch at these shapes needs, and how
// many of them the current device runs at once (occupancy API; 0: none).
template <typename T, int D, int GB>
int clusters(int B, int H, int KH, int splits, int out[2]) {
  constexpr int smem = decode_smem_bytes<T, D, GB>();
  const cudaError_t err = allow_decode_smem<T, D, GB>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  out[0] = B * KH * (H / KH / GB);
  out[1] = 0;
  return (int)cudaOccupancyMaxActiveClusters(&out[1], decode_fwd_kernel<T, D, GB>, &cfg);
}

template <typename T, int D, int GB>
int launch(const void* q, const void* kc, const void* vc, const int* positions,
           const int* next_pos, void* o, float* lse, int B, int C, int H, int KH, int window,
           int splits, cudaStream_t stream) {
  constexpr int smem = decode_smem_bytes<T, D, GB>();
  cudaError_t err = allow_decode_smem<T, D, GB>();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (C + BK - 1) / BK;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KH * (H / KH / GB), B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale = (float)(1.0 / sqrt((double)D));
  err = cudaLaunchKernelEx(&cfg, decode_fwd_kernel<T, D, GB>, (const T*)q, (const T*)kc,
                           (const T*)vc, positions, next_pos, (T*)o, lse, C, H, KH, window,
                           scale, tiles_per_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One call per GB (heads sharing a tile, from G = H/KH) and D: `Op` is
// launch or clusters, instantiated at <T, D, GB>.
struct Launch {
  template <typename T, int D, int GB, typename... A>
  static int run(A... a) { return launch<T, D, GB>(a...); }
};
struct Clusters {
  template <typename T, int D, int GB, typename... A>
  static int run(A... a) { return clusters<T, D, GB>(a...); }
};

template <typename Op, typename T, int D, typename... A>
int dispatch_g(int G, A... a) {
  if (G % 8 == 0) return Op::template run<T, D, 8>(a...);
  if (G % 4 == 0) return Op::template run<T, D, 4>(a...);
  if (G % 2 == 0) return Op::template run<T, D, 2>(a...);
  return Op::template run<T, D, 1>(a...);
}

template <typename Op, typename T, typename... A>
int dispatch_d(int D, int G, A... a) {
  switch (D) {
    case 16: return dispatch_g<Op, T, 16>(G, a...);
    case 32: return dispatch_g<Op, T, 32>(G, a...);
    case 64: return dispatch_g<Op, T, 64>(G, a...);
    case 80: return dispatch_g<Op, T, 80>(G, a...);
    case 128: return dispatch_g<Op, T, 128>(G, a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Op, typename... A>
int dispatch(int H, int KH, int D, int dtype, int splits, A... a) {
  if (KH <= 0 || H % KH || splits <= 0 || splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_F32) return dispatch_d<Op, float>(D, H / KH, a...);
  if (dtype == DTYPE_BF16) return dispatch_d<Op, __nv_bfloat16>(D, H / KH, a...);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// positions: int32 (C,) on the device; next_pos: one int32 on the device.
// splits: cache splits per (batch, KV head), 1..8, one thread-block cluster
// of them; decode_attention.py::splits_for chooses them.  window <= 0 means
// no window.  lse: null, or f32 (B,H) for each row's log-sum-exp.  Returns
// the launch's error code.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache, const void* v_cache,
                                    const void* positions, const void* next_pos, void* o,
                                    void* lse, int B, int C, int H, int KH, int D, int window,
                                    int splits, int dtype, void* stream) {
  if (B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  return repro_torch::dispatch<repro_torch::Launch>(
      H, KH, D, dtype, splits, q, k_cache, v_cache, (const int*)positions,
      (const int*)next_pos, o, (float*)lse, B, C, H, KH, window, splits,
      (cudaStream_t)stream);
}

// out = {clusters of `splits` blocks that decode_attention_fwd launches at
// these shapes, clusters of that size the current device runs at once}.
extern "C" int decode_attention_clusters(int B, int H, int KH, int D, int dtype, int splits,
                                         int* out) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  return repro_torch::dispatch<repro_torch::Clusters>(H, KH, D, dtype, splits, B, H, KH, splits,
                                                      out);
}
