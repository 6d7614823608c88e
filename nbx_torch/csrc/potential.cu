// Softened potential per target, float32, for NVIDIA Hopper (sm_90a).
//
//   phi_i = -G * sum_j m_j (|d_ij|^2 + eps^2)^(-1/2),   d_ij = p_j - p_i
//
// Replaces the TPU kernel `_potential_kernel` of nbx/ops/pairwise.py:682
// (behind `potential_per_body`, whose energy the drift gate samples). It
// keeps that kernel's contract: Nt targets against Ns sources, the i == j
// self term -G m_i / eps left in the output (the wrapper removes it, which
// needs each target to appear once among the sources), mass-0 sources inert,
// the output scaled by -G once at the end. The TPU kernel sums the masses
// through a HIGHEST-precision matrix product; here the sum is plain float32,
// with no tensor cores and no TF32.
//
// Design: K6's (pairwise_accjerk.cu) with one accumulator a target. 256
// threads a block, each with kTargets = 4 targets in registers (target t of
// thread l in block x: row x kRows + t kThreads + l), so that a source
// (x, y, z, m) read from shared memory serves 4 of them; and a second grid
// dimension over the sources (split_sum.cuh), so that the drift gate's
// 16,384 bodies still fill the card: 16 target blocks x 32 splits of 2
// tiles = 512 blocks (128 with one thread a target and no split). 2 targets
// a thread ran 14-19% slower (PERF.md). The block walks its split's
// sources in tiles of 256, loaded cooperatively into shared memory; each
// thread sums one tile into a partial per target and adds it to its running
// total. The split's totals go to part[s, i]; `combine_splits<1>` adds the
// splits in order and multiplies by -G, without atomics, so the same inputs
// give the same bits. Source lanes past Ns load mass 0; target rows past Nt
// sum from the origin and store nothing.
//
// Bound: a pair issues 3 differences, r^2 + eps^2 as three FMAs, one MUFU.RSQ
// (rsqrt.approx.ftz where eps^2 is a normal float32, rsqrtf below) and the
// weighted sum (one FMA), and 1 / 4 shared loads: about 8 issue slots,
// against the SFU's 16 results a clock an SM, which make one MUFU the time of
// 8 issue slots. The SFU bounds it.

#include <cfloat>
#include <cuda_runtime.h>

#include "split_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTargets = 4;  // ops/pairwise.py POTENTIAL_TARGETS
constexpr int kRows = kThreads * kTargets;
constexpr int kTile = nbx_sum::kTile;
static_assert(kTile == kThreads, "one source a thread at the tile's load");

template <bool kFtz>
__global__ void __launch_bounds__(kThreads)
potential_kernel(const float* __restrict__ tgt,   // [nt, 3]
                 const float4* __restrict__ src,  // [ns] (x, y, z, m)
                 float* __restrict__ part,        // [splits, nt]
                 int nt, int ns, float eps2, int tiles_per_split) {
  __shared__ float4 tile[kTile];
  const int i0 = blockIdx.x * kRows + threadIdx.x;
  float xi[kTargets], yi[kTargets], zi[kTargets], total[kTargets];
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = i0 + t * kThreads;
    const bool live = i < nt;
    xi[t] = live ? tgt[3 * i + 0] : 0.f;
    yi[t] = live ? tgt[3 * i + 1] : 0.f;
    zi[t] = live ? tgt[3 * i + 2] : 0.f;
    total[t] = 0.f;
  }
  const int2 range = nbx_sum::split_range(ns, tiles_per_split);
  for (int j0 = range.x; j0 < range.y; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    tile[threadIdx.x] = j < ns ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    float sum[kTargets];
#pragma unroll
    for (int t = 0; t < kTargets; ++t) sum[t] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      const float4 s = tile[k];
#pragma unroll
      for (int t = 0; t < kTargets; ++t) {
        const float dx = s.x - xi[t];
        const float dy = s.y - yi[t];
        const float dz = s.z - zi[t];
        const float inv = nbx_sum::rsqrt_of<kFtz>(__fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, eps2))));
        sum[t] = __fmaf_rn(s.w, inv, sum[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kTargets; ++t) total[t] += sum[t];
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.y) * nt;
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = i0 + t * kThreads;
    if (i < nt) out[i] = total[t];
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. `rows` = kThreads kTargets, the
// targets a block (the wrapper's POTENTIAL_ROWS); `part` is [splits, nt]
// float32 scratch, splits = ceil(ceil(ns / 256) / tiles_per_split) (at
// least 1). Launches the split sum and the combine on `stream` and returns
// the launches' cudaError_t (0 on success); it does not synchronise.
// MUFU.RSQ alone where eps^2 is a normal float32, rsqrtf below.
extern "C" int nbx_potential(const void* tgt, const void* src, void* part, void* phi, int nt, int ns, float g,
                             float eps2, int rows, int tiles_per_split, void* stream) {
  if (nt <= 0) return static_cast<int>(cudaSuccess);
  if (tiles_per_split <= 0 || rows != kRows) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(tgt);
  auto* p = static_cast<float*>(part);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto kernel = eps2 >= FLT_MIN ? potential_kernel<true> : potential_kernel<false>;
  const int splits = nbx_sum::split_count(ns, tiles_per_split);
  kernel<<<dim3((nt + kRows - 1) / kRows, splits), kThreads, 0, st>>>(t, static_cast<const float4*>(src), p, nt, ns,
                                                                      eps2, tiles_per_split);
  nbx_sum::combine<1>(p, t, static_cast<float*>(phi), nt, splits, -g, st);
  return static_cast<int>(cudaGetLastError());
}
