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
// Design: one thread per target, 256 threads per block. The block walks the
// sources in tiles of 256 float4 (x, y, z, m), loaded cooperatively into
// shared memory; the loop over tiles takes the place of the TPU grid's
// sequential source axis and its accumulator carried in VMEM. Each thread
// sums one tile into a partial and adds the partial to its running total, a
// two-level sum that keeps the float32 rounding of a 262,144-term sum near
// that of a 1,024-term one. The kernel masks the ragged edges itself: source
// lanes past Ns load mass 0, target threads past Nt store nothing.
//
// Bound: once a tile is in shared memory a pair costs 0 bytes of device
// memory traffic (a shared-memory broadcast read) and about a dozen FP32
// instructions plus one rsqrtf on the SFU, so the kernel is bound by FP32 and
// SFU issue. Speed work (unrolling over several targets per thread, float4
// target tiles, more blocks in flight at small N) is for later changes; this
// version is the simple, correct one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;

__global__ void __launch_bounds__(kThreads)
pairwise_f32r_kernel(const float* __restrict__ tgt,   // [nt, 3]
                     const float4* __restrict__ src,  // [ns] (x, y, z, m)
                     float* __restrict__ acc,         // [nt, 3]
                     int nt, int ns, float g, float eps2) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (i < nt) {
    xi = tgt[3 * i + 0];
    yi = tgt[3 * i + 1];
    zi = tgt[3 * i + 2];
  }
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int j0 = 0; j0 < ns; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    tile[threadIdx.x] = j < ns ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    float tx = 0.f, ty = 0.f, tz = 0.f;
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const float4 s = tile[k];
      const float dx = s.x - xi;
      const float dy = s.y - yi;
      const float dz = s.z - zi;
      const float r2 = dx * dx + dy * dy + dz * dz + eps2;
      const float inv = rsqrtf(r2);
      const float w = inv * inv * inv * s.w;  // f * m_j
      tx += w * dx;
      ty += w * dy;
      tz += w * dz;
    }
    ax += tx;
    ay += ty;
    az += tz;
    __syncthreads();
  }
  if (i < nt) {
    acc[3 * i + 0] = ax * g;
    acc[3 * i + 1] = ay * g;
    acc[3 * i + 2] = az * g;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// the launch's cudaError_t (0 on success); it does not synchronise.
extern "C" int nbx_pairwise_f32r(const void* tgt, const void* src, void* acc,
                                 int nt, int ns, float g, float eps2,
                                 void* stream) {
  if (nt <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (nt + kThreads - 1) / kThreads;
  pairwise_f32r_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tgt), static_cast<const float4*>(src),
      static_cast<float*>(acc), nt, ns, g, eps2);
  return static_cast<int>(cudaGetLastError());
}
