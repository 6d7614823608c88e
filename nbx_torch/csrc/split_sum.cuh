// What the direct sums that split their sources share, float32, for NVIDIA
// Hopper (sm_90a): "f32r" (pairwise_f32r.cu, K1), "f32", "hyb" and "bf16"
// (pairwise_precision.cu, K1a, K1d, K1e), "fast" (pairwise_fast.cu, K1b),
// "mxu" (pairwise_mxu.cu, K1c), the acc+jerk sum (pairwise_accjerk.cu,
// K6) and the potential (potential.cu, K3), and the roundings of "mxu" and
// "hyb".
//
// The source split: block (x, s) of a kernel sums its targets against split
// s of the sources, a contiguous run of `tiles_per_split` whole tiles of
// kTile sources (the last split may hold fewer), so that every tile and its
// centroid are those of the unsplit sum. Each split writes its float32
// partials to part[s, i, :]; `combine_splits` then adds the S partials of
// target i in split order, part[0] + part[1] + ..., applies the final
// cancellation of "f32" and "fast" and multiplies by G. No sum uses atomics,
// so the same inputs give the same bits run after run. The wrapper
// (nbx_torch/ops/pairwise.py, `source_splits`) chooses S from the shapes
// alone.

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace nbx_sum {

constexpr int kTile = 256;  // sources a tile, one a thread at the load

// 1 / sqrt(x). kFtz: rsqrt.approx.ftz.f32 alone (MUFU.RSQ), which gives
// rsqrtf's bits for every normal x; the launcher takes it where x >= eps^2
// is normal (eps^2 >= FLT_MIN), so rsqrtf's guard for subnormal arguments
// (2 FMULs and a compare a call) never runs. Otherwise rsqrtf.
template <bool kFtz>
__device__ __forceinline__ float rsqrt_of(float x) {
  if constexpr (kFtz) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  } else {
    return rsqrtf(x);
  }
}

// fma(a.z, b.z, fma(a.y, b.y, a.x b.x)): the cross term.
__device__ __forceinline__ float cross3(float ax, float ay, float az, float bx, float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

// fma(z, z, fma(x, x, y y)): a square, rounded otherwise than cross3(v, v).
__device__ __forceinline__ float square3(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(x, x, __fmul_rn(y, y)));
}

// The tile's centroid: the mean of v over all kTile lanes, padding lanes
// included, summed by a halving tree (lane l plus lane l + h, h = kTile / 2,
// ..., 1: shared memory, then warp shuffles) whatever the number of tiles,
// as the plain version sums it. Blocks of kTile threads; every thread gets
// it and must call it.
__device__ __forceinline__ float3 tree_mean(float3 v, float3* red, float3* mean) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int h = kTile / 2; h >= 32; h >>= 1) {
    if (t < h) red[t] = make_float3(red[t].x + red[t + h].x, red[t].y + red[t + h].y, red[t].z + red[t + h].z);
    __syncthreads();
  }
  if (t < 32) {
    float3 s = red[t];
    for (int o = 16; o > 0; o >>= 1) {
      s.x += __shfl_down_sync(0xffffffffu, s.x, o);
      s.y += __shfl_down_sync(0xffffffffu, s.y, o);
      s.z += __shfl_down_sync(0xffffffffu, s.z, o);
    }
    if (t == 0) *mean = make_float3(s.x * (1.f / kTile), s.y * (1.f / kTile), s.z * (1.f / kTile));
  }
  __syncthreads();
  return *mean;
}

// Splits of ns sources into runs of tiles_per_split tiles: at least one,
// also for ns = 0, whose one split sums nothing.
inline int split_count(int ns, int tiles_per_split) {
  const int tiles = ns > 0 ? (ns + kTile - 1) / kTile : 1;
  return (tiles + tiles_per_split - 1) / tiles_per_split;
}

// Sources [lo, hi) of this block's split, lo a whole tile.
__device__ __forceinline__ int2 split_range(int ns, int tiles_per_split) {
  const int lo = blockIdx.y * tiles_per_split * kTile;
  return make_int2(lo, min(ns, lo + tiles_per_split * kTile));
}

// acc_i = G o_i, o_i = part[0, i] + part[1, i] + ... in split order; for
// kWidth 4 (o_xyz, o_w) the cancellation o_xyz - p_i o_w comes first; for
// kWidth 6 (K6's acc and jerk) o[0:3] goes to acc and o[3:6] to acc2; for
// kWidth 1 (K3's potential, acc [nt]) acc_i = G o_i alone.
template <int kWidth>
__global__ void combine_splits(const float* __restrict__ part,  // [splits, nt, kWidth]
                               const float* __restrict__ tgt,   // [nt, 3]
                               float* __restrict__ acc,         // [nt, 3]; [nt] for kWidth 1
                               float* __restrict__ acc2,        // [nt, 3], kWidth 6 only
                               int nt, int splits, float g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nt) return;
  float o[kWidth];
#pragma unroll
  for (int c = 0; c < kWidth; ++c) o[c] = part[i * kWidth + c];
  for (int s = 1; s < splits; ++s) {
    const float* p = part + (static_cast<size_t>(s) * nt + i) * kWidth;
#pragma unroll
    for (int c = 0; c < kWidth; ++c) o[c] = __fadd_rn(o[c], p[c]);
  }
  if constexpr (kWidth == 1) {
    acc[i] = o[0] * g;
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = kWidth == 4 ? __fsub_rn(o[c], __fmul_rn(tgt[3 * i + c], o[kWidth - 1])) : o[c];
      acc[3 * i + c] = v * g;
    }
    if constexpr (kWidth == 6) {
#pragma unroll
      for (int c = 0; c < 3; ++c) acc2[3 * i + c] = o[3 + c] * g;
    }
  }
}

// Launch the combine on `stream` after the split kernel.
template <int kWidth>
void combine(const float* part, const float* tgt, float* acc, int nt, int splits, float g, cudaStream_t stream,
             float* acc2 = nullptr) {
  constexpr int kThreads = 256;
  combine_splits<kWidth><<<(nt + kThreads - 1) / kThreads, kThreads, 0, stream>>>(part, tgt, acc, acc2, nt, splits,
                                                                                  g);
}

// A split sum of three partials a target: kernel(tgt [nt, 3], src [ns]
// (x, y, z, m), part [splits, nt, 3], nt, ns, eps^2, tiles_per_split).
using Kernel3 = void (*)(const float*, const float4*, float*, int, int, float, int);

// The C entry of a Kernel3: `kernel` over the split grid (kTile threads a
// block, `rows` targets a block), then combine_splits<3>, on `stream`;
// returns the launches' cudaError_t (0 on success), does not synchronise.
inline int launch3(Kernel3 kernel, int rows, const void* tgt, const void* src, void* part, void* acc, int nt, int ns,
                   float g, float eps2, int tiles_per_split, void* stream) {
  if (nt <= 0) return static_cast<int>(cudaSuccess);
  if (tiles_per_split <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(tgt);
  auto* p = static_cast<float*>(part);
  const auto st = static_cast<cudaStream_t>(stream);
  const int splits = split_count(ns, tiles_per_split);
  kernel<<<dim3((nt + rows - 1) / rows, splits), kTile, 0, st>>>(t, static_cast<const float4*>(src), p, nt, ns, eps2,
                                                                  tiles_per_split);
  combine<3>(p, t, static_cast<float*>(acc), nt, splits, g, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nbx_sum
