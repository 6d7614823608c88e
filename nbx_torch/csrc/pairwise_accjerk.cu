// Softened acceleration and jerk in one pass, float32, for NVIDIA Hopper
// (sm_90a): the force evaluation of the 4th-order Hermite integrator.
//
//   w = m_j / s^3,  s^2 = |d|^2 + eps^2,  d = p_j - p_i,  dv = v_j - v_i
//   acc_i  = G * sum_j w d
//   jerk_i = G * sum_j w (dv - 3 (d . dv) / s^2 d)
//
// Replaces the TPU kernel `_accjerk_kernel` of nbx/ops/pairwise.py:573
// (behind `pairwise_acc_jerk`). It keeps that kernel's contract, not its
// blocks: Nt targets against Ns sources (Nt != Ns allowed), no diagonal mask
// (the self pair has d = dv = 0 and adds exactly 0, which needs eps > 0),
// mass-0 sources inert, float32 sums, G applied once at the end.
//
// Design: K1's (pairwise_f32r.cu). 256 threads a block, each with kTargets
// = 2 targets in registers (target t of thread l in block x: row x kThreads
// kTargets + t kThreads + l), so that a source's two float4, (x, y, z, m)
// and (vx, vy, vz, 0), are read from shared memory once for both; and a
// second grid dimension over the sources (split_sum.cuh), so that small N
// still fills the card: at the drift gate's 16,384 bodies, 32 target blocks
// x 16 splits of 4 tiles = 512 blocks (128 with one thread a target and no
// split). 4 targets a thread took 124 registers, two blocks an SM, and ran
// 2.5% slower there (PERF.md). The block walks its split's sources in tiles
// of 256, loaded cooperatively into shared memory; each thread sums one tile
// into a partial per target and adds the partial to its running total. The
// split's six totals go to part[s, i, 0:6]; `combine_splits<6>` adds the
// splits in order, multiplies by G and writes acc and jerk, without
// atomics, so the same inputs give the same bits. Source lanes past Ns load
// mass 0; target rows past Nt sum from the origin and store nothing.
//
// Bound: once a tile is in shared memory a pair costs no device-memory
// traffic and FP32 issue bounds the kernel: 6 differences, r^2 + eps^2 as
// three FMAs, one MUFU.RSQ, 1/s^2 and m/s^3 (3), d.dv (3), 3 (d.dv)/s^2 (2),
// the acc sums (3 FMAs), the jerk terms and sums (6 FMAs), and 2 / kTargets
// shared loads. rsqrt.approx.ftz alone replaces rsqrtf (and its guard for
// subnormal arguments) where eps^2 is normal (split_sum.cuh).

#include <cfloat>
#include <cuda_runtime.h>

#include "split_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTargets = 2;  // ops/pairwise.py ACCJERK_TARGETS
constexpr int kTile = nbx_sum::kTile;
static_assert(kTile == kThreads, "one source a thread at the tile's load");

template <bool kFtz>
__global__ void __launch_bounds__(kThreads)
pairwise_accjerk_kernel(const float* __restrict__ tgt_pos,  // [nt, 3]
                        const float* __restrict__ tgt_vel,  // [nt, 3]
                        const float4* __restrict__ src,     // [ns, 2] (x, y, z, m), (vx, vy, vz, 0)
                        float* __restrict__ part,           // [splits, nt, 6]
                        int nt, int ns, float eps2, int tiles_per_split) {
  __shared__ float4 tile_p[kTile];
  __shared__ float4 tile_v[kTile];
  const int i0 = blockIdx.x * kThreads * kTargets + threadIdx.x;
  float xi[kTargets], yi[kTargets], zi[kTargets], vxi[kTargets], vyi[kTargets], vzi[kTargets];
  float ax[kTargets], ay[kTargets], az[kTargets], jx[kTargets], jy[kTargets], jz[kTargets];
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = i0 + t * kThreads;
    const bool live = i < nt;
    xi[t] = live ? tgt_pos[3 * i + 0] : 0.f;
    yi[t] = live ? tgt_pos[3 * i + 1] : 0.f;
    zi[t] = live ? tgt_pos[3 * i + 2] : 0.f;
    vxi[t] = live ? tgt_vel[3 * i + 0] : 0.f;
    vyi[t] = live ? tgt_vel[3 * i + 1] : 0.f;
    vzi[t] = live ? tgt_vel[3 * i + 2] : 0.f;
    ax[t] = ay[t] = az[t] = jx[t] = jy[t] = jz[t] = 0.f;
  }
  const int2 range = nbx_sum::split_range(ns, tiles_per_split);
  for (int j0 = range.x; j0 < range.y; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    tile_p[threadIdx.x] = j < ns ? src[2 * j + 0] : zero;
    tile_v[threadIdx.x] = j < ns ? src[2 * j + 1] : zero;
    __syncthreads();
    float tax[kTargets], tay[kTargets], taz[kTargets], tjx[kTargets], tjy[kTargets], tjz[kTargets];
#pragma unroll
    for (int t = 0; t < kTargets; ++t) tax[t] = tay[t] = taz[t] = tjx[t] = tjy[t] = tjz[t] = 0.f;
#pragma unroll 2
    for (int k = 0; k < kTile; ++k) {
      const float4 p = tile_p[k];
      const float4 v = tile_v[k];
#pragma unroll
      for (int t = 0; t < kTargets; ++t) {
        const float dx = p.x - xi[t];
        const float dy = p.y - yi[t];
        const float dz = p.z - zi[t];
        const float dvx = v.x - vxi[t];
        const float dvy = v.y - vyi[t];
        const float dvz = v.z - vzi[t];
        const float inv = nbx_sum::rsqrt_of<kFtz>(__fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, eps2))));
        const float inv2 = inv * inv;
        const float w = inv * inv2 * p.w;                                  // m_j / s^3
        const float c = (3.f * nbx_sum::cross3(dx, dy, dz, dvx, dvy, dvz)) * inv2;  // 3 (d.dv) / s^2
        tax[t] = __fmaf_rn(w, dx, tax[t]);
        tay[t] = __fmaf_rn(w, dy, tay[t]);
        taz[t] = __fmaf_rn(w, dz, taz[t]);
        tjx[t] = __fmaf_rn(w, __fmaf_rn(-c, dx, dvx), tjx[t]);
        tjy[t] = __fmaf_rn(w, __fmaf_rn(-c, dy, dvy), tjy[t]);
        tjz[t] = __fmaf_rn(w, __fmaf_rn(-c, dz, dvz), tjz[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kTargets; ++t) {
      ax[t] += tax[t];
      ay[t] += tay[t];
      az[t] += taz[t];
      jx[t] += tjx[t];
      jy[t] += tjy[t];
      jz[t] += tjz[t];
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.y) * nt * 6;
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = i0 + t * kThreads;
    if (i < nt) {
      float* o = out + 6 * static_cast<size_t>(i);
      o[0] = ax[t];
      o[1] = ay[t];
      o[2] = az[t];
      o[3] = jx[t];
      o[4] = jy[t];
      o[5] = jz[t];
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. `part` is [splits, nt, 6] float32
// scratch, splits = ceil(ceil(ns / 256) / tiles_per_split) (at least 1).
// Launches the split sum and the combine on `stream` and returns the
// launches' cudaError_t (0 on success); it does not synchronise. MUFU.RSQ
// alone where eps^2 is a normal float32, rsqrtf below.
extern "C" int nbx_pairwise_accjerk(const void* tgt_pos, const void* tgt_vel, const void* src, void* part,
                                    void* acc, void* jerk, int nt, int ns, float g, float eps2, int tiles_per_split,
                                    void* stream) {
  if (nt <= 0) return static_cast<int>(cudaSuccess);
  if (tiles_per_split <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* tp = static_cast<const float*>(tgt_pos);
  auto* p = static_cast<float*>(part);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto kernel = eps2 >= FLT_MIN ? pairwise_accjerk_kernel<true> : pairwise_accjerk_kernel<false>;
  const int splits = nbx_sum::split_count(ns, tiles_per_split);
  constexpr int kRows = kThreads * kTargets;
  kernel<<<dim3((nt + kRows - 1) / kRows, splits), kThreads, 0, st>>>(
      tp, static_cast<const float*>(tgt_vel), static_cast<const float4*>(src), p, nt, ns, eps2, tiles_per_split);
  nbx_sum::combine<6>(p, tp, static_cast<float*>(acc), nt, splits, g, st, static_cast<float*>(jerk));
  return static_cast<int>(cudaGetLastError());
}
