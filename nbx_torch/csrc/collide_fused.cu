// Fused collision pass over occupancy-bucketed windows, float32, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_collide_kernel_fused` of nbx/ops/collide.py:236
// (body `_collide_fused_body`, :280), as launched by the bucketed layout of
// `binned_collision_pass`. It keeps that kernel's contract, not its blocks:
// for every target body of a window, against the window's fused source lanes
// (9 neighbour-column strips of B + 2 cells, each cut to its kept length, then
// masked by the symmetric-drop mask), it sums
//
//   dv  = -(1/m_i) sum (a2 d - ft rv),     a2 = (j + ft vn) / dist
//   dp  = -(1/m_i) sum c2 d,               c2 = (min_d - dist)/dist * 0.8 mu
//   heat = 0.2 (1/m_i) sum 1/2 vn (mu vn)  (approaching pairs only)
//   n_bounce = number of approaching overlapping pairs
//
// with mu = m_i m_j / (m_i + m_j) (one reciprocal per pair), j = -(1+e) mu vn
// and ft = friction * mu, and picks the deepest-overlap partner: the largest
// min_d - dist over overlapping pairs, ties to the smallest body id. A pair
// overlaps when both masses are > 0, the ids differ, and r^2 < min_d^2.
//
// Design: one thread block per window, threads striding over the window's
// targets (a thread keeps its 8 sums and its (depth, id) in registers). The
// block reads its own window descriptor (target start and count in the
// cell-sorted order, 9 strip starts and kept lengths) and stages the fused
// source lanes from the cell-sorted copy of the bodies into shared memory in
// chunks of 256, so any source cap fits in static shared memory. That loop
// takes the place of the TPU kernel's 128-lane chunk loop and of the
// materialised [blocks, 16, S] source blocks the Pallas BlockSpecs needed.
// Each thread writes its results straight to body order through order[p]:
// every body holds at most one target slot, so writes never collide and no
// epilogue gather or scatter is needed. Masked source lanes load mass 0 and
// fail the overlap test.
//
// Bound: the TPU kernel evaluated the full ~60-op pair math on every lane of
// sum over windows of t_rows * 9 s_capw (padding included). Here a lane costs
// the overlap test (about a dozen FP32 ops on shared-memory operands) and only
// overlapping pairs, a few per target, take the rest (one rsqrtf, one
// division, ~40 FP32 ops), so the kernel is bound by FP32 issue on the overlap
// test and by the latency of staging; a target row count that is not a multiple
// of 32 idles part of the last warp. Decisions (r^2, the overlap test, the
// depth, the sign of vn) are computed without FMA contraction, as the plain
// PyTorch version computes them, so partners and counters agree exactly.
// Speed work (cp.async staging, several targets per thread, splitting a
// window's sources over warps) is for later changes.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kChunk = 256;  // source lanes staged per pass
constexpr int kWinInts = 20;  // ts, tn, 9 x (strip start, kept length)
constexpr float kCorrection = 0.8f;
constexpr float kHeat = 0.2f;
constexpr float kSentinel = -1e30f;

__global__ void __launch_bounds__(kMaxThreads)
collide_fused_kernel(const float4* __restrict__ feats,          // [n, 2] sorted: (x y z vx), (vy vz m r)
                     const int* __restrict__ order,             // [n] sorted position -> body id
                     const unsigned char* __restrict__ src_ok,  // [n] sorted position may be a source
                     const int* __restrict__ win,               // [n_win, 20]
                     float* __restrict__ out_d,                 // [n, 8] body order
                     int* __restrict__ out_j,                   // [n] body order
                     float e, float fric) {
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk];
  __shared__ float svx[kChunk], svy[kChunk], svz[kChunk];
  __shared__ float sm[kChunk], sr[kChunk];
  __shared__ int sg[kChunk];
  __shared__ int s_start[9], s_off[10];

  const int* wd = win + static_cast<size_t>(blockIdx.x) * kWinInts;
  const int ts = wd[0];
  const int tn = wd[1];
  if (tn <= 0) return;  // the same for every thread of the block
  if (threadIdx.x == 0) {
    int off = 0;
    for (int s = 0; s < 9; ++s) {
      s_start[s] = wd[2 + 2 * s];
      s_off[s] = off;
      off += wd[3 + 2 * s];
    }
    s_off[9] = off;
  }
  __syncthreads();
  const int total = s_off[9];
  const float one_e = 1.f + e;

  for (int t0 = 0; t0 < tn; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const bool active = t < tn;
    const int p = ts + (active ? t : 0);
    const float4 fa = feats[2 * p];
    const float4 fb = feats[2 * p + 1];
    const float xi = fa.x, yi = fa.y, zi = fa.z;
    const float vxi = fa.w, vyi = fb.x, vzi = fb.y;
    const float mi = fb.z, ri = fb.w;
    const int gi = order[p];

    float a0 = 0.f, a1 = 0.f, a2s = 0.f, a3 = 0.f, a4 = 0.f, a5 = 0.f, a6 = 0.f, a7 = 0.f;
    float dmax = kSentinel;
    int jsel = INT_MAX;

    for (int c0 = 0; c0 < total; c0 += kChunk) {
      const int nc = min(kChunk, total - c0);
      __syncthreads();  // every thread is done with the previous chunk
      for (int l = threadIdx.x; l < nc; l += blockDim.x) {
        const int lane = c0 + l;
        int s = 0;
        while (lane >= s_off[s + 1]) ++s;
        const int q = s_start[s] + (lane - s_off[s]);
        const float4 ga = feats[2 * q];
        const float4 gb = feats[2 * q + 1];
        sx[l] = ga.x;
        sy[l] = ga.y;
        sz[l] = ga.z;
        svx[l] = ga.w;
        svy[l] = gb.x;
        svz[l] = gb.y;
        sm[l] = src_ok[q] ? gb.z : 0.f;
        sr[l] = gb.w;
        sg[l] = order[q];
      }
      __syncthreads();
      if (!active || !(mi > 0.f)) continue;
      for (int k = 0; k < nc; ++k) {
        const float dx = __fsub_rn(sx[k], xi);
        const float dy = __fsub_rn(sy[k], yi);
        const float dz = __fsub_rn(sz[k], zi);
        const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        const float mj = sm[k];
        const float min_d = __fadd_rn(ri, sr[k]);
        const int gj = sg[k];
        if (!(mj > 0.f) || gj == gi || !(r2 < __fmul_rn(min_d, min_d))) continue;

        const float inv_dist = rsqrtf(r2 > 0.f ? r2 : 1.f);
        const float dist = __fmul_rn(r2, inv_dist);
        const float depth = __fsub_rn(min_d, dist);
        if (depth > dmax || (depth == dmax && gj < jsel)) {
          dmax = depth;
          jsel = gj;
        }
        const float rvx = __fsub_rn(svx[k], vxi);
        const float rvy = __fsub_rn(svy[k], vyi);
        const float rvz = __fsub_rn(svz[k], vzi);
        const float vn = __fmul_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(rvx, dx), __fmul_rn(rvy, dy)), __fmul_rn(rvz, dz)), inv_dist);
        if (!(vn < 0.f)) continue;  // not approaching: every term is 0

        const float m_sum = mi + mj;
        const float r_ms = 1.f / (m_sum > 0.f ? m_sum : 1.f);
        const float mu = mi * mj * r_ms;
        const float tvn = vn * mu;
        const float j_imp = -one_e * tvn;
        const float ft = fric * mu;
        const float c_a = (j_imp + ft * vn) * inv_dist;
        const float c_b = (min_d - dist) * inv_dist * (kCorrection * mu);
        a0 += c_a * dx - ft * rvx;
        a1 += c_a * dy - ft * rvy;
        a2s += c_a * dz - ft * rvz;
        a3 += c_b * dx;
        a4 += c_b * dy;
        a5 += c_b * dz;
        a6 += 0.5f * vn * tvn;
        a7 += 1.f;
      }
    }
    if (active) {
      const float sc = mi > 0.f ? 1.f / mi : 0.f;
      float* o = out_d + static_cast<size_t>(gi) * 8;
      o[0] = -a0 * sc;
      o[1] = -a1 * sc;
      o[2] = -a2s * sc;
      o[3] = -a3 * sc;
      o[4] = -a4 * sc;
      o[5] = -a5 * sc;
      o[6] = a6 * sc * kHeat;
      o[7] = a7;
      out_j[gi] = dmax > 0.f ? jsel : -1;
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. One block of `threads` threads
// (a multiple of 32, at most 256) per window. Launches on `stream` and
// returns the launch's cudaError_t (0 on success); it does not synchronise.
extern "C" int nbx_collide_fused(const void* feats, const void* order, const void* src_ok,
                                 const void* win, void* out_d, void* out_j, int n_win,
                                 int threads, float e, float fric, void* stream) {
  if (n_win <= 0) return static_cast<int>(cudaSuccess);
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  collide_fused_kernel<<<n_win, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feats), static_cast<const int*>(order),
      static_cast<const unsigned char*>(src_ok), static_cast<const int*>(win),
      static_cast<float*>(out_d), static_cast<int*>(out_j), e, fric);
  return static_cast<int>(cudaGetLastError());
}
