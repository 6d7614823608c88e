// The P3M short-range pair law shared by K4 (pp_short.cu), K5 (pp_react.cu)
// and K7 (collide_fused.cu), float32, for NVIDIA Hopper (sm_90a).
//
//   acc_i = G sum_j w_ij d_ij,   d_ij = p_j - p_i,
//   w_ij  = m_j [erfc(x)/s + c_a e^(-x^2)] / s^2,   s = sqrt(r^2 + eps^2),
//   x = s / a,  c_a = 2 / (a sqrt(pi)),
//
// masked to 0 unless r^2 > 0 and m_j > 0, with erfc(x) from the Abramowitz &
// Stegun 7.1.26 polynomial in the Horner order of the TPU kernels
// (nbx/ops/ppkernel.py:109-115). One form, one MUFU instruction a special
// function (rsqrt.approx.ftz where eps^2 is normal, ex2.approx.ftz,
// rcp.approx.ftz) with the constants folded (below): pair_base_approx (K5),
// and pair_base_unmasked with keep_pair's select (K4 and K7, the weight
// times m_j). The plain versions take the exact functions; each MUFU is
// within 2 ulp of its IEEE counterpart (PTX ISA), so a weight moves by a
// few float32 roundings, far inside the kernels' 1e-5 of max|plain|.

#pragma once

#include <cuda_runtime.h>

namespace nbx_pp {

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

// w where r^2 > 0 and m_j > 0, else 0 (K4's and K7's weight m_j wbase): one
// select in PTX. Written as `?:` in C++, with m_j > 0 uniform across a warp
// (a staged source), the compiler branches around the whole law instead: a
// branch and a move a pair.
__device__ __forceinline__ float keep_pair(float w, float r2, float mj) {
  float y;
  asm("{\n\t.reg .pred p;\n\tsetp.gt.f32 p, %3, 0f00000000;\n\tsetp.gt.and.f32 p, %2, 0f00000000, p;\n\t"
      "selp.f32 %0, %1, 0f00000000, p;\n\t}"
      : "=f"(y)
      : "f"(w), "f"(r2), "f"(mj));
  return y;
}

// The law: the weight without the source mass, wbase = [erfc(x)/s +
// c_a e^(-x^2)] / s^2, 0 where r^2 = 0 (a select, so that a coincident
// pair's 0 * inf never enters a sum). One MUFU instruction a special
// function:
//   1/s: rsqrt.approx.ftz (kFtz, where eps^2 >= FLT_MIN, so s^2 is normal),
//        or rsqrtf of s^2 guarded at 0 (eps^2 below FLT_MIN, eps = 0 too);
//   e^(-x^2) = ex2.approx.ftz(s^2 k_ex), k_ex = -log2(e) / a^2;
//   t = rcp.approx.ftz(1 + k_p s), k_p = p / a;
//   wbase = ex2 (poly t / s + c_a) / s^2, poly in the Horner order above.
// Each is within 2 ulp of its IEEE counterpart (PTX ISA), so wbase moves by a
// few float32 roundings against the exact functions'.
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

// wbase before the r^2 > 0 select.
template <bool kFtz>
__device__ __forceinline__ float pair_base_unmasked(float r2, const LawApprox& law) {
  const float s2 = r2 + law.eps2;
  const float inv_s = kFtz ? rsqrt_approx(s2) : rsqrtf(s2 > 0.f ? s2 : 1.f);
  const float ex2 = ex2_approx(s2 * law.k_ex);
  const float tt = rcp_approx(__fmaf_rn(law.k_p, s2 * inv_s, 1.f));
  float poly = kAs5;
  poly = __fmaf_rn(poly, tt, kAs4);
  poly = __fmaf_rn(poly, tt, kAs3);
  poly = __fmaf_rn(poly, tt, kAs2);
  poly = __fmaf_rn(poly, tt, kAs1);
  return (ex2 * __fmaf_rn(poly * tt, inv_s, law.c_a)) * (inv_s * inv_s);
}

// K5's form. The weight is computed first and then selected, so that the
// compiler selects (FSEL) rather than branching around the law.
template <bool kFtz>
__device__ __forceinline__ float pair_base_approx(float r2, const LawApprox& law) {
  const float w = pair_base_unmasked<kFtz>(r2, law);
  return r2 > 0.f ? w : 0.f;
}

}  // namespace nbx_pp
