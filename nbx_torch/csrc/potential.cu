// Softened potential per target, float32, for NVIDIA Hopper (sm_90a).
//
//   phi_i = -G * sum_j m_j (|d_ij|^2 + eps^2)^(-1/2),   d_ij = p_j - p_i
//
// Replaces the TPU kernel `_potential_kernel` of nbx/ops/pairwise.py (behind
// `potential_per_body`, whose energy the drift gate samples). It keeps that
// kernel's contract: Nt targets against Ns sources, the i == j self term
// -G m_i / eps left in the output (the wrapper removes it, which needs each
// target to appear once among the sources), mass-0 sources inert, the output
// scaled by -G once at the end. The TPU kernel sums the masses through a
// HIGHEST-precision matrix product; here the sum is plain float32, with no
// tensor cores and no TF32.
//
// Design: the skeleton of pairwise_f32r.cu with one accumulator per target.
// One thread per target, 128 threads per block (at N = 16,384 that is 128
// blocks for the card's 132 SMs), 128 sources (x, y, z, m) staged in shared
// memory at a time, a two-level (tile, then total) float32 sum. Source lanes
// past Ns load mass 0; target threads past Nt store nothing.
//
// Bound: 11 FP32 operations a pair (3 differences, r^2 + eps^2 (6), the
// weighted sum (2)) against one rsqrtf on the SFU, whose rate is a sixteenth
// of the FP32 lanes': the kernel is bound by the SFU.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = kThreads;

__global__ void __launch_bounds__(kThreads)
potential_kernel(const float* __restrict__ tgt,   // [nt, 3]
                 const float4* __restrict__ src,  // [ns] (x, y, z, m)
                 float* __restrict__ phi,         // [nt]
                 int nt, int ns, float g, float eps2) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (i < nt) {
    xi = tgt[3 * i + 0];
    yi = tgt[3 * i + 1];
    zi = tgt[3 * i + 2];
  }
  float total = 0.f;
  for (int j0 = 0; j0 < ns; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    tile[threadIdx.x] = j < ns ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    float part = 0.f;
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const float4 s = tile[k];
      const float dx = s.x - xi;
      const float dy = s.y - yi;
      const float dz = s.z - zi;
      const float r2 = dx * dx + dy * dy + dz * dz + eps2;
      part += s.w * rsqrtf(r2);
    }
    total += part;
    __syncthreads();
  }
  if (i < nt) phi[i] = -g * total;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// the launch's cudaError_t (0 on success); it does not synchronise.
extern "C" int nbx_potential(const void* tgt, const void* src, void* phi, int nt, int ns, float g,
                             float eps2, void* stream) {
  if (nt <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (nt + kThreads - 1) / kThreads;
  potential_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tgt), static_cast<const float4*>(src), static_cast<float*>(phi),
      nt, ns, g, eps2);
  return static_cast<int>(cudaGetLastError());
}
