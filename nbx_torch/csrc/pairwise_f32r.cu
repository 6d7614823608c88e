// Softened direct-sum gravity, float32, for NVIDIA Hopper (sm_90a).
//
//   acc_i = G * sum_j m_j d_ij (|d_ij|^2 + eps^2)^(-3/2),   d_ij = p_j - p_i
//
// Replaces the TPU kernel `_f32r_acc_kernel` of nbx/ops/pairwise.py (behind
// `pairwise_acc`, precision "f32r"). It keeps that kernel's contract, not its
// blocks: Nt targets against Ns sources (Nt != Ns allowed), no diagonal mask
// (the self pair contributes w * 0 = 0, which needs eps > 0), mass-0 sources
// inert, float32 sums, G applied once at the end.
//
// Design: 256 threads a block, each with kTargets = 4 targets in registers
// (target t of thread l in block x: row x kThreads kTargets + t kThreads +
// l), so that a source's float4 (x, y, z, m) is read from shared memory once
// for 4 targets; and a second grid dimension over the sources
// (split_sum.cuh), so that small N still fills the card: at the drift gate's
// 16,384 bodies, 16 target blocks x 32 splits of 2 tiles = 512 blocks (64
// with one thread a target). The block walks its split's sources in tiles of
// 256 float4, loaded cooperatively into shared memory; each thread sums one
// tile into a partial per target and adds the partial to its running total,
// a two-level sum that keeps the float32 rounding of a 262,144-term sum near
// that of a 1,024-term one. The split's totals go to part[s, i, 0:3];
// `combine_splits` adds the splits in order and multiplies by G, without
// atomics, so the same inputs give the same bits. The kernel masks the
// ragged edges itself: source lanes past Ns load mass 0, target rows past Nt
// sum from the origin and store nothing.
//
// Bound: once a tile is in shared memory a pair costs 0 bytes of device
// memory traffic and FP32 and SFU issue bound the kernel. A pair issues 3
// differences, r^2 + eps^2 as three FMAs (fma(dz, dz, fma(dy, dy, fma(dx,
// dx, eps^2)))), one MUFU.RSQ, 3 FMULs for m / r^3 and 3 FMAs for the sums,
// and 1 / kTargets shared loads. rsqrt.approx.ftz alone replaces rsqrtf
// (and its guard for subnormal arguments) where eps^2 is normal
// (split_sum.cuh).

#include <cfloat>
#include <cuda_runtime.h>

#include "split_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = nbx_sum::kTile;
constexpr int kTargets = 4;  // ops/pairwise.py TARGETS
static_assert(kTile == kThreads, "one source a thread at the tile's load");

template <bool kFtz>
__global__ void __launch_bounds__(kThreads)
pairwise_f32r_kernel(const float* __restrict__ tgt,   // [nt, 3]
                     const float4* __restrict__ src,  // [ns] (x, y, z, m)
                     float* __restrict__ part,        // [splits, nt, 3]
                     int nt, int ns, float eps2, int tiles_per_split) {
  __shared__ float4 tile[kTile];
  const int i0 = blockIdx.x * kThreads * kTargets + threadIdx.x;
  float xi[kTargets], yi[kTargets], zi[kTargets];
  float ax[kTargets], ay[kTargets], az[kTargets];  // the split's totals, before G
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = i0 + t * kThreads;
    xi[t] = i < nt ? tgt[3 * i + 0] : 0.f;
    yi[t] = i < nt ? tgt[3 * i + 1] : 0.f;
    zi[t] = i < nt ? tgt[3 * i + 2] : 0.f;
    ax[t] = ay[t] = az[t] = 0.f;
  }
  const int2 range = nbx_sum::split_range(ns, tiles_per_split);
  for (int j0 = range.x; j0 < range.y; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    tile[threadIdx.x] = j < ns ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    float tx[kTargets], ty[kTargets], tz[kTargets];
#pragma unroll
    for (int t = 0; t < kTargets; ++t) tx[t] = ty[t] = tz[t] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      const float4 s = tile[k];
#pragma unroll
      for (int t = 0; t < kTargets; ++t) {
        const float dx = s.x - xi[t];
        const float dy = s.y - yi[t];
        const float dz = s.z - zi[t];
        const float r2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, eps2)));
        const float inv = nbx_sum::rsqrt_of<kFtz>(r2);
        const float w = inv * inv * inv * s.w;  // f * m_j
        tx[t] = __fmaf_rn(w, dx, tx[t]);
        ty[t] = __fmaf_rn(w, dy, ty[t]);
        tz[t] = __fmaf_rn(w, dz, tz[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kTargets; ++t) {
      ax[t] += tx[t];
      ay[t] += ty[t];
      az[t] += tz[t];
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.y) * nt * 3;
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = i0 + t * kThreads;
    if (i < nt) {
      out[3 * i + 0] = ax[t];
      out[3 * i + 1] = ay[t];
      out[3 * i + 2] = az[t];
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. `part` is [splits, nt, 3] float32
// scratch, splits = ceil(ceil(ns / 256) / tiles_per_split) (at least 1).
// Launches the split sum and the combine on `stream` and returns the
// launches' cudaError_t (0 on success); it does not synchronise. MUFU.RSQ
// alone where eps^2 is a normal float32, rsqrtf below.
extern "C" int nbx_pairwise_f32r(const void* tgt, const void* src, void* part, void* acc, int nt, int ns, float g,
                                 float eps2, int tiles_per_split, void* stream) {
  return nbx_sum::launch3(eps2 >= FLT_MIN ? pairwise_f32r_kernel<true> : pairwise_f32r_kernel<false>,
                          kThreads * kTargets, tgt, src, part, acc, nt, ns, g, eps2, tiles_per_split, stream);
}
