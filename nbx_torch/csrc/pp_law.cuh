// The P3M short-range pair law shared by K4 (pp_short.cu), K5 (pp_react.cu)
// and K7 (collide_fused.cu), and the thread-block pass of K4, float32, for
// NVIDIA Hopper (sm_90a).
//
//   acc_i = G sum_j w_ij d_ij,   d_ij = p_j - p_i,
//   w_ij  = m_j [erfc(x)/s + c_a e^(-x^2)] / s^2,   s = sqrt(r^2 + eps^2),
//   x = (s^2 rsqrt(s^2)) (1/a),  c_a = 2 / (a sqrt(pi)),
//
// masked to 0 unless r^2 > 0 and m_j > 0, with erfc(x) from the Abramowitz &
// Stegun 7.1.26 polynomial in the Horner order of the TPU kernels
// (nbx/ops/ppkernel.py:109-115). Two forms:
//   pair_weight (K4, K7): rsqrtf, expf and the IEEE reciprocal __frcp_rn, so
//   that the fused collision-gravity kernel reproduces K4 bit for bit;
//   pair_base_approx (K5): one MUFU instruction each, rsqrt.approx.ftz
//   where eps^2 is normal, ex2.approx.ftz and rcp.approx.ftz, and the
//   constants folded (below).
//
// A pass of K4 is a list of work items. Item w is one row of `win`:
//   win[w] = (ts, tn, s0, l0, s1, l1, ...): targets tgt[ts .. ts + tn) against
//   the source rows src[s .. s + l) of each of its n_strips strips.
// One thread block runs one item, one thread per target (striding when tn
// exceeds the block), and stages each strip through shared memory kTile rows
// at a time; the loop over strips and tiles takes the place of the TPU grid's
// materialised [8, S] source block. Each thread writes G acc to row
// tgt_out[ts + t] of `out` (none where it is < 0), so a pass whose targets
// map to distinct rows needs no atomics and is deterministic. Rows past a
// strip's length are never read: on the TPU such a parked row (mass 0) adds
// exactly 0.

#pragma once

#include <cuda_runtime.h>

namespace nbx_pp {

constexpr int kTile = 256;  // source rows staged per pass through shared memory
constexpr int kMaxThreads = 256;

// A&S 7.1.26: erfc(x) = t (a1 + t (a2 + t (a3 + t (a4 + t a5)))) e^(-x^2),
// t = 1 / (1 + p x), x >= 0, |error| <= 1.5e-7.
constexpr float kAsP = 0.3275911f;
constexpr float kAs1 = 0.254829592f;
constexpr float kAs2 = -0.284496736f;
constexpr float kAs3 = 1.421413741f;
constexpr float kAs4 = -1.453152027f;
constexpr float kAs5 = 1.061405429f;

struct Law {
  float eps2, inv_a, c_a, g;
};

struct Pass {
  const float4* tgt;   // target rows (x, y, z, m)
  const int* tgt_out;  // [rows of tgt] output row of each target, < 0 = none
  const float4* src;   // source rows (x, y, z, m)
  const int* win;      // [n_win, 2 + 2 n_strips] work items
  float* out;          // [rows, 3]
  int n_win;
  int n_strips;
};

__device__ __forceinline__ float pair_weight(float r2, float mj, const Law& law) {
  const float s2 = r2 + law.eps2;
  const float inv_s = rsqrtf(s2 > 0.f ? s2 : 1.f);
  const float x = (s2 * inv_s) * law.inv_a;
  const float ex2 = expf(-x * x);
  const float tt = __frcp_rn(1.f + kAsP * x);
  float poly = kAs5;
  poly = poly * tt + kAs4;
  poly = poly * tt + kAs3;
  poly = poly * tt + kAs2;
  poly = poly * tt + kAs1;
  const float erfc_x = poly * tt * ex2;
  const float w = mj * (erfc_x * inv_s + law.c_a * ex2) * (inv_s * inv_s);
  return (r2 > 0.f && mj > 0.f) ? w : 0.f;
}

// K5's law: the weight without the source mass, wbase = [erfc(x)/s +
// c_a e^(-x^2)] / s^2, 0 where r^2 = 0 (a select, so that a coincident
// pair's 0 * inf never enters a sum). One MUFU instruction a special
// function:
//   1/s: rsqrt.approx.ftz (kFtz, where eps^2 >= FLT_MIN, so s^2 is normal),
//        or rsqrtf of s^2 guarded at 0 (eps^2 below FLT_MIN, eps = 0 too);
//   e^(-x^2) = ex2.approx.ftz(s^2 k_ex), k_ex = -log2(e) / a^2;
//   t = rcp.approx.ftz(1 + k_p s), k_p = p / a;
//   wbase = ex2 (poly t / s + c_a) / s^2, poly in the Horner order above.
// Each is within 2 ulp of its IEEE counterpart (PTX ISA), so wbase moves by a
// few float32 roundings against pair_weight's.
struct LawApprox {
  float eps2, k_ex, k_p, c_a;
};

__device__ __forceinline__ LawApprox approx_of(const Law& law) {
  return LawApprox{law.eps2, -1.44269504f * (law.inv_a * law.inv_a), kAsP * law.inv_a, law.c_a};
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool kFtz>
__device__ __forceinline__ float pair_base_approx(float r2, const LawApprox& law) {
  const float s2 = r2 + law.eps2;
  const float inv_s = kFtz ? rsqrt_approx(s2) : rsqrtf(s2 > 0.f ? s2 : 1.f);
  const float ex2 = ex2_approx(s2 * law.k_ex);
  const float tt = rcp_approx(__fmaf_rn(law.k_p, s2 * inv_s, 1.f));
  float poly = kAs5;
  poly = __fmaf_rn(poly, tt, kAs4);
  poly = __fmaf_rn(poly, tt, kAs3);
  poly = __fmaf_rn(poly, tt, kAs2);
  poly = __fmaf_rn(poly, tt, kAs1);
  const float w = (ex2 * __fmaf_rn(poly * tt, inv_s, law.c_a)) * (inv_s * inv_s);
  return r2 > 0.f ? w : 0.f;
}

// Runs item w of pass p with the calling block. Every thread of the block
// must call it (it synchronises the block).
__device__ __forceinline__ void run_item(const Pass& p, int w, const Law& law) {
  __shared__ float4 tile[kTile];
  const int* wd = p.win + static_cast<size_t>(w) * (2 + 2 * p.n_strips);
  const int ts = wd[0];
  const int tn = wd[1];
  for (int t0 = 0; t0 < tn; t0 += blockDim.x) {  // the same trip count for every thread
    const int t = t0 + threadIdx.x;
    const bool active = t < tn;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (active) {
      const float4 q = p.tgt[ts + t];
      xi = q.x;
      yi = q.y;
      zi = q.z;
    }
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (int s = 0; s < p.n_strips; ++s) {
      const int ss = wd[2 + 2 * s];
      const int sl = wd[3 + 2 * s];
      for (int c0 = 0; c0 < sl; c0 += kTile) {
        const int nc = min(kTile, sl - c0);
        __syncthreads();  // every thread is done with the previous tile
        for (int l = threadIdx.x; l < nc; l += blockDim.x) tile[l] = p.src[ss + c0 + l];
        __syncthreads();
        if (!active) continue;
        // a tile's partial sum, then the running total: float32 rounding of
        // a long sum stays near that of a tile-sized one
        float px = 0.f, py = 0.f, pz = 0.f;
#pragma unroll 4
        for (int k = 0; k < nc; ++k) {
          const float4 q = tile[k];
          const float dx = q.x - xi;
          const float dy = q.y - yi;
          const float dz = q.z - zi;
          const float wk = pair_weight(dx * dx + dy * dy + dz * dz, q.w, law);
          px += wk * dx;
          py += wk * dy;
          pz += wk * dz;
        }
        ax += px;
        ay += py;
        az += pz;
      }
    }
    if (active) {
      const int o = p.tgt_out[ts + t];
      if (o >= 0) {
        float* r = p.out + static_cast<size_t>(o) * 3;
        r[0] = law.g * ax;
        r[1] = law.g * ay;
        r[2] = law.g * az;
      }
    }
  }
}

inline bool bad_threads(int threads) {
  return threads <= 0 || threads > kMaxThreads || threads % 32 != 0;
}

}  // namespace nbx_pp
