// Softened acceleration and jerk in one pass, float32, for NVIDIA Hopper
// (sm_90a): the force evaluation of the 4th-order Hermite integrator.
//
//   w = m_j / s^3,  s^2 = |d|^2 + eps^2,  d = p_j - p_i,  dv = v_j - v_i
//   acc_i  = G * sum_j w d
//   jerk_i = G * sum_j w (dv - 3 (d . dv) / s^2 d)
//
// Replaces the TPU kernel `_accjerk_kernel` of nbx/ops/pairwise.py (behind
// `pairwise_acc_jerk`). It keeps that kernel's contract, not its blocks: Nt
// targets against Ns sources (Nt != Ns allowed), no diagonal mask (the self
// pair has d = dv = 0 and adds exactly 0, which needs eps > 0), mass-0
// sources inert, float32 sums, G applied once at the end.
//
// Design: the skeleton of K1's first version. One thread per target, 128
// threads per block: at the drift gate's N = 16,384 that is 128 blocks for
// the card's 132 SMs, where 256 threads would leave half of them idle. A
// source is two float4, (x, y, z, m) and (vx, vy, vz, 0); the block stages
// 128 sources (4 KB) in shared memory at a time. Each thread sums one tile
// into partials and adds them to its running totals, a two-level sum as in
// K1. Source lanes past Ns load mass 0; target threads past Nt store nothing.
//
// Bound: once a tile is in shared memory a pair costs no device memory
// traffic and 40 FP32 operations (counted as in chip_smoke.py: 6
// differences, r^2 + eps^2 (6), m/s^3 (3), 3 (d.dv)/s^2 (7), the acc sum
// (6), the jerk terms and sums (12)) plus one rsqrtf on the SFU, so the
// kernel is bound by FP32 issue. Speed work (several targets per thread,
// sources split across blocks at small N) is for later changes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = kThreads;

__global__ void __launch_bounds__(kThreads)
pairwise_accjerk_kernel(const float* __restrict__ tgt_pos,  // [nt, 3]
                        const float* __restrict__ tgt_vel,  // [nt, 3]
                        const float4* __restrict__ src,     // [ns, 2] (x, y, z, m), (vx, vy, vz, 0)
                        float* __restrict__ acc,            // [nt, 3]
                        float* __restrict__ jerk,           // [nt, 3]
                        int nt, int ns, float g, float eps2) {
  __shared__ float4 tile_p[kTile];
  __shared__ float4 tile_v[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f, vxi = 0.f, vyi = 0.f, vzi = 0.f;
  if (i < nt) {
    xi = tgt_pos[3 * i + 0];
    yi = tgt_pos[3 * i + 1];
    zi = tgt_pos[3 * i + 2];
    vxi = tgt_vel[3 * i + 0];
    vyi = tgt_vel[3 * i + 1];
    vzi = tgt_vel[3 * i + 2];
  }
  float ax = 0.f, ay = 0.f, az = 0.f, jx = 0.f, jy = 0.f, jz = 0.f;
  for (int j0 = 0; j0 < ns; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    tile_p[threadIdx.x] = j < ns ? src[2 * j + 0] : zero;
    tile_v[threadIdx.x] = j < ns ? src[2 * j + 1] : zero;
    __syncthreads();
    float tax = 0.f, tay = 0.f, taz = 0.f, tjx = 0.f, tjy = 0.f, tjz = 0.f;
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      const float4 p = tile_p[k];
      const float4 v = tile_v[k];
      const float dx = p.x - xi;
      const float dy = p.y - yi;
      const float dz = p.z - zi;
      const float dvx = v.x - vxi;
      const float dvy = v.y - vyi;
      const float dvz = v.z - vzi;
      const float r2 = dx * dx + dy * dy + dz * dz + eps2;
      const float inv = rsqrtf(r2);
      const float inv2 = inv * inv;
      const float w = inv * inv2 * p.w;                           // m_j / s^3
      const float c = 3.f * (dx * dvx + dy * dvy + dz * dvz) * inv2;  // 3 (d.dv) / s^2
      tax += w * dx;
      tay += w * dy;
      taz += w * dz;
      tjx += w * (dvx - c * dx);
      tjy += w * (dvy - c * dy);
      tjz += w * (dvz - c * dz);
    }
    ax += tax;
    ay += tay;
    az += taz;
    jx += tjx;
    jy += tjy;
    jz += tjz;
    __syncthreads();
  }
  if (i < nt) {
    acc[3 * i + 0] = ax * g;
    acc[3 * i + 1] = ay * g;
    acc[3 * i + 2] = az * g;
    jerk[3 * i + 0] = jx * g;
    jerk[3 * i + 1] = jy * g;
    jerk[3 * i + 2] = jz * g;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// the launch's cudaError_t (0 on success); it does not synchronise.
extern "C" int nbx_pairwise_accjerk(const void* tgt_pos, const void* tgt_vel, const void* src,
                                    void* acc, void* jerk, int nt, int ns, float g, float eps2,
                                    void* stream) {
  if (nt <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (nt + kThreads - 1) / kThreads;
  pairwise_accjerk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tgt_pos), static_cast<const float*>(tgt_vel),
      static_cast<const float4*>(src), static_cast<float*>(acc), static_cast<float*>(jerk), nt, ns,
      g, eps2);
  return static_cast<int>(cudaGetLastError());
}
