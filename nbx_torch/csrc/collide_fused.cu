// Fused collision pass over window descriptors, float32, for NVIDIA Hopper
// (sm_90a).
//
// Replaces four TPU kernels of nbx/ops/collide.py, as the layouts of
// `binned_collision_pass` and the spatial step's local entries launch them:
// `_collide_kernel_fused` (:236, body `_collide_fused_body` :280; the
// bucketed, banded, band-packed and compacted layouts), `_collide_kernel`
// (:112, the full-column layout: a column against its 9 neighbour columns in
// 9 scalar-prefetch-driven revisits that merge into one output block),
// `_collide_kernel_fused_multi` (:242, several windows per program) and
// `_collide_kernel_fused_grav` (:261, the P3M short-range gravity summed over
// the same lanes, below). It keeps those kernels' contract, not their blocks:
// for every target body of a window, against the window's fused source lanes
// (9 neighbour-column strips, each cut to its kept length, then masked by the
// symmetric-drop mask), it sums
//
//   dv  = -(1/m_i) sum (a2 d - ft rv),     a2 = (j + ft vn) / dist
//   dp  = -(1/m_i) sum c2 d,               c2 = (min_d - dist)/dist * 0.8 mu
//   heat = 0.2 (1/m_i) sum 1/2 vn (mu vn)  (approaching pairs only)
//   n_bounce = number of approaching overlapping pairs
//
// with mu = m_i m_j / (m_i + m_j) (one reciprocal per pair), j = -(1+e) mu vn
// and ft = friction * mu, and picks the deepest-overlap partner: the largest
// min_d - dist over overlapping pairs, ties to the smallest body id. A pair
// overlaps when both masses are > 0, the ids differ, and r^2 < min_d^2. K8's
// own arithmetic (two reciprocals, normalised normals and tangents) is the
// same physics; its pair set and partner rule are the same, so a full column
// is one window here: its targets against its 9 neighbour columns' kept
// bodies, in a single visit.
//
// Design: one thread block per window (per windows_per_block consecutive
// windows, walked in turn, for K2m: the same per-window code, so the result
// is bitwise that of one window a block), threads striding over the window's
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
//
// With gravity (kGrav, the TPU kernel K7): every lane of the window, not only
// the overlapping pairs, also adds the P3M short-range pull of
// csrc/pp_law.cuh (its exact form, pair_weight: rsqrtf, expf and the IEEE
// reciprocal, in the TPU kernels' Horner order; K4 and K5 take the one-MUFU
// form) to the target,
//
//   grav_i = G sum_j w_ij d_ij,  w_ij = m_j [erfc(x)/s + c_a e^(-x^2)] / s^2,
//
// masked to 0 unless both masses are > 0, the ids differ and r^2 > 0 (a
// masked source lane carries mass 0), in per-chunk partial sums.
// That term comes before the overlap test, so every lane pays an rsqrt, an
// exp and a reciprocal: K7 is bound by the SFU rate on the window's lanes,
// not by FP32 issue as K2 is. The gravity sum needs no rule on FMA
// contraction; the collision decisions keep theirs, so K7's delta rows and
// partners are K2's. K2's instantiation has no gravity code.

#include <climits>
#include <cuda_runtime.h>

#include "pp_law.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kChunk = 256;  // source lanes staged per pass
constexpr int kWinInts = 20;  // ts, tn, 9 x (strip start, kept length)
constexpr float kCorrection = 0.8f;
constexpr float kHeat = 0.2f;
constexpr float kSentinel = -1e30f;

// kMulti = false: block b runs window b alone (the TPU kernels K2 and K8);
// kMulti = true: block b walks windows [b W, (b + 1) W) in turn (K2m). One
// body of code, so both compute each window bit for bit alike; the
// single-window instantiation keeps neither the loop nor its barrier.
// kGrav = true adds the short-range gravity sum into out_g (K7); out_g and
// law come last, so K2's instantiation keeps its parameters where they were.
template <bool kMulti, bool kGrav>
__global__ void __launch_bounds__(kMaxThreads)
collide_fused_kernel(const float4* __restrict__ feats,          // [n, 2] sorted: (x y z vx), (vy vz m r)
                     const int* __restrict__ order,             // [n] sorted position -> body id
                     const unsigned char* __restrict__ src_ok,  // [n] sorted position may be a source
                     const int* __restrict__ win,               // [n_win, 20]
                     float* __restrict__ out_d,                 // [n, 8] body order
                     int* __restrict__ out_j,                   // [n] body order
                     int n_win, int windows_per_block, float e, float fric,
                     float* __restrict__ out_g,                 // [n, 3] body order (kGrav)
                     nbx_pp::Law law) {
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk];
  __shared__ float svx[kChunk], svy[kChunk], svz[kChunk];
  __shared__ float sm[kChunk], sr[kChunk];
  __shared__ int sg[kChunk];
  __shared__ int s_start[9], s_off[10];

  const float one_e = 1.f + e;
  const int w_begin = kMulti ? static_cast<int>(blockIdx.x) * windows_per_block : static_cast<int>(blockIdx.x);
  const int w_end = kMulti ? min(n_win, w_begin + windows_per_block) : w_begin + 1;
  for (int wi = w_begin; wi < w_end; ++wi) {
    const int* wd = win + static_cast<size_t>(wi) * kWinInts;
    const int ts = wd[0];
    const int tn = wd[1];
    if (tn <= 0) continue;  // the same for every thread of the block
    if (kMulti) __syncthreads();  // every thread is done with the previous window's strips and chunk
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
      float gx = 0.f, gy = 0.f, gz = 0.f;

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
        float px = 0.f, py = 0.f, pz = 0.f;  // this chunk's gravity (kGrav)
        for (int k = 0; k < nc; ++k) {
          const float dx = __fsub_rn(sx[k], xi);
          const float dy = __fsub_rn(sy[k], yi);
          const float dz = __fsub_rn(sz[k], zi);
          const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
          const float mj = sm[k];
          const float min_d = __fadd_rn(ri, sr[k]);
          const int gj = sg[k];
          if (kGrav) {
            const float wg = gj != gi ? nbx_pp::pair_weight(r2, mj, law) : 0.f;
            px += wg * dx;
            py += wg * dy;
            pz += wg * dz;
          }
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
        if (kGrav) {
          gx += px;
          gy += py;
          gz += pz;
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
        if (kGrav) {
          float* og = out_g + static_cast<size_t>(gi) * 3;
          og[0] = law.g * gx;
          og[1] = law.g * gy;
          og[2] = law.g * gz;
        }
      }
    }
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. One block of `threads` threads
// (a multiple of 32, at most 256) per `windows_per_block` windows (per window
// with gravity). Each launches on `stream` and returns the launch's
// cudaError_t (0 on success); neither synchronises.
extern "C" int nbx_collide_fused(const void* feats, const void* order, const void* src_ok,
                                 const void* win, void* out_d, void* out_j, int n_win,
                                 int windows_per_block, int threads, float e, float fric,
                                 void* stream) {
  if (n_win <= 0) return static_cast<int>(cudaSuccess);
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0 || windows_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* f = static_cast<const float4*>(feats);
  const int* o = static_cast<const int*>(order);
  const unsigned char* ok = static_cast<const unsigned char*>(src_ok);
  const int* w = static_cast<const int*>(win);
  float* d = static_cast<float*>(out_d);
  int* j = static_cast<int*>(out_j);
  const nbx_pp::Law none{0.f, 0.f, 0.f, 0.f};
  if (windows_per_block == 1) {
    collide_fused_kernel<false, false><<<n_win, threads, 0, s>>>(f, o, ok, w, d, j, n_win, 1, e, fric, nullptr,
                                                                 none);
  } else {
    const int wpb = windows_per_block < n_win ? windows_per_block : n_win;
    collide_fused_kernel<true, false><<<(n_win + wpb - 1) / wpb, threads, 0, s>>>(f, o, ok, w, d, j, n_win, wpb,
                                                                                  e, fric, nullptr, none);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7: nbx_collide_fused, one window a block, plus the short-range gravity
// G sum_j w_ij d_ij of every target into out_g [n, 3] (body order); the law's
// constants as the JAX package's parameter row holds them: 1/a, 2/(a sqrt(pi)),
// eps^2.
extern "C" int nbx_collide_fused_grav(const void* feats, const void* order, const void* src_ok,
                                      const void* win, void* out_d, void* out_j, void* out_g, int n_win,
                                      int threads, float e, float fric, float g, float inv_a, float c_a,
                                      float eps2, void* stream) {
  if (n_win <= 0) return static_cast<int>(cudaSuccess);
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const nbx_pp::Law law{eps2, inv_a, c_a, g};
  collide_fused_kernel<false, true><<<n_win, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feats), static_cast<const int*>(order),
      static_cast<const unsigned char*>(src_ok), static_cast<const int*>(win), static_cast<float*>(out_d),
      static_cast<int*>(out_j), n_win, 1, e, fric, static_cast<float*>(out_g), law);
  return static_cast<int>(cudaGetLastError());
}
