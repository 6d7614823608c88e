// Softened direct-sum gravity at the study precisions of `pairwise_acc`,
// float32 in and out, for NVIDIA Hopper (sm_90a).
//
//   acc_i = G * sum_j m_j d_ij (|d_ij|^2 + eps^2)^(-3/2),   d_ij = p_j - p_i
//
// Replaces four TPU kernels of nbx/ops/pairwise.py, all behind
// `pairwise_acc` (call site :537), each with its own entry:
//
//   nbx_pairwise_f32   precision "f32"  `_acc_kernel` (:51)        K1a
//   nbx_pairwise_fast  precision "fast" `_fast_acc_kernel` (:93)   K1b
//   nbx_pairwise_hyb   precision "hyb"  `_hyb_acc_kernel` (:302)   K1d
//   nbx_pairwise_bf16  precision "bf16" `_bf16_acc_kernel` (:400)  K1e
//
// Each keeps its TPU kernel's formulation and its places of rounding and
// cancellation, which are the variant (the precision study of BASELINE
// config 4), not the TPU's blocks or matrix unit:
//
// - "f32": f = (|d|^2 + eps^2)^(-3/2) a pair, o = sum_j f S_j with the
//   mass-folded S = (m x, m y, m z, m), then o_xyz - p_i o_m once, at the end:
//   a cancellation over the whole source range.
// - "fast": per source tile, S centred on the tile's centroid c (s_c = S -
//   (c m, 0)), the product as three bf16 passes (f_hi s_hi + f_hi s_lo +
//   f_lo s_hi, hi = bf16(v), lo = bf16(v - hi)) with float32 sums, c sum_j f m
//   added back per tile, then "f32"'s cancellation. A product of two bf16
//   values is exact in float32, so FP32 FMAs on the CUDA cores compute what
//   the TPU's bf16 passes compute; only the order of the float32 sums could
//   differ, and it does not (below).
// - "hyb": per source tile, r^2 by the centred identity |p_i - c|^2 +
//   |p_j - c|^2 - 2 (p_i - c).(p_j - c), all in float32 (on Hopper the 3-deep
//   cross term is three FP32 operations; TF32 would lose it), floored at
//   eps^2; w = m / r^3; the centred sums sum_j w (p_j - c) and sum_j w,
//   un-centred per tile as s - (p_i - c) sum_j w.
// - "bf16": d rounded to bf16; each of d d, f^3 m and w d a bf16 product
//   (never fused into an FMA); r^2 and the row sums in float32.
//
// Design: K1's (csrc/pairwise_f32r.cu): one thread per target, 256 threads a
// block, the sources in tiles of 256 loaded cooperatively into shared memory,
// each tile summed into a partial that is then added to the running total,
// ragged edges masked here (source lanes past Ns load position 0 and mass 0,
// as the TPU kernel's padding lanes; target threads past Nt store nothing).
// What a tile needs per source is formed once, at the load: the centroid of
// "fast" and "hyb" (the mean over every lane of the tile, padding included,
// as the TPU kernel's mean over its padded tile; a halving tree, so that it
// does not depend on how many tiles there are), "fast"'s split of s_c,
// "hyb"'s centred source and |p_j - c|^2 + eps^2, "bf16"'s rounded m. The
// wrapper builds S with torch ops. Where a cancellation follows, the kernel
// rounds each product and sum in the order the plain PyTorch version rounds
// them (`__fmul_rn`, `__fadd_rn`: nvcc would otherwise contract a * b + c
// into an FMA), and sums each tile's lanes and then the tiles one after
// another, as the plain version does; a cancellation amplifies any other
// rounding by |p| / |d|.
//
// Bound: as K1, once a tile is in shared memory a pair costs no device-memory
// traffic; FP32 operations, one rsqrtf a pair on the SFU and, for "fast" and
// "bf16", float32-to-bf16 conversions (16 a clock an SM, as the SFU) bound
// the kernels: chip_smoke.py counts each term. Speed work (bf16 products as
// packed `__nv_bfloat162`, mma.sync for "fast", several targets a thread) is
// for later changes; this version is the simple, correct one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;

enum class Precision { kF32, kFast, kHyb, kBf16 };

// f32(bf16(v)), rounded to nearest even.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// (a.x b.x + a.y b.y) + a.z b.z, every product and sum rounded in turn.
__device__ __forceinline__ float dot3_rn(float ax, float ay, float az, float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// The tile's centroid: the mean of v over all kTile lanes, padding lanes
// included, summed by a halving tree (lane l plus lane l + h, h = kTile / 2,
// ..., 1: shared memory, then warp shuffles) whatever the number of tiles,
// as the plain version sums it. Every thread of the block gets it; every
// thread must call it.
__device__ __forceinline__ float3 tile_mean(float3 v, float3* red, float3* mean) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int h = kTile / 2; h >= 32; h >>= 1) {
    if (t < h) red[t] = make_float3(red[t].x + red[t + h].x, red[t].y + red[t + h].y, red[t].z + red[t + h].z);
    __syncthreads();
  }
  if (t < 32) {
    float3 s = red[t];
    for (int o = 16; o > 0; o >>= 1) {
      s.x += __shfl_down_sync(0xffffffffu, s.x, o);
      s.y += __shfl_down_sync(0xffffffffu, s.y, o);
      s.z += __shfl_down_sync(0xffffffffu, s.z, o);
    }
    if (t == 0) *mean = make_float3(s.x * (1.f / kTile), s.y * (1.f / kTile), s.z * (1.f / kTile));
  }
  __syncthreads();
  return *mean;
}

// (|d|^2 + eps^2)^(-3/2) for d = q - p_i, r^2 summed as the plain version
// sums it.
__device__ __forceinline__ float inv_cube(float4 q, float xi, float yi, float zi, float eps2) {
  const float dx = q.x - xi, dy = q.y - yi, dz = q.z - zi;
  const float inv = rsqrtf(__fadd_rn(dot3_rn(dx, dy, dz, dx, dy, dz), eps2));
  return inv * inv * inv;
}

template <Precision P>
__global__ void __launch_bounds__(kThreads)
pairwise_precision_kernel(const float* __restrict__ tgt,    // [nt, 3]
                          const float4* __restrict__ src,   // [ns] (x, y, z, m)
                          const float4* __restrict__ smat,  // [ns] (m x, m y, m z, m): f32, fast
                          float* __restrict__ acc,          // [nt, 3]
                          int nt, int ns, float g, float eps2) {
  __shared__ float4 pos_tile[kTile];       // (x, y, z, m); hyb: (x - c, y - c, z - c, m)
  __shared__ float4 hi_tile[kTile];        // f32: S; fast: hi of s_c
  __shared__ float4 lo_tile[kTile];        // fast: lo of s_c
  __shared__ float r2_tile[kTile];         // hyb: |p_j - c|^2 + eps^2
  __shared__ __nv_bfloat16 m_tile[kTile];  // bf16: bf16(m)
  __shared__ float3 red[kTile], mean;      // fast, hyb: the centroid's sums
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (i < nt) {
    xi = tgt[3 * i + 0];
    yi = tgt[3 * i + 1];
    zi = tgt[3 * i + 2];
  }
  // Running totals over the tiles. f32, fast: (sum f m x, sum f m y,
  // sum f m z, sum f m); hyb, bf16: the acceleration before G (ow unused).
  float ox = 0.f, oy = 0.f, oz = 0.f, ow = 0.f;
  for (int j0 = 0; j0 < ns; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    const float4 p = j < ns ? src[j] : zero4;
    float cx = 0.f, cy = 0.f, cz = 0.f;
    if constexpr (P == Precision::kFast || P == Precision::kHyb) {
      const float3 c = tile_mean(make_float3(p.x, p.y, p.z), red, &mean);
      cx = c.x;
      cy = c.y;
      cz = c.z;
    }
    pos_tile[threadIdx.x] = p;
    if constexpr (P == Precision::kF32) {
      hi_tile[threadIdx.x] = j < ns ? smat[j] : zero4;
    } else if constexpr (P == Precision::kFast) {
      const float4 s = j < ns ? smat[j] : zero4;
      const float4 sc = make_float4(__fsub_rn(s.x, __fmul_rn(cx, s.w)), __fsub_rn(s.y, __fmul_rn(cy, s.w)),
                                    __fsub_rn(s.z, __fmul_rn(cz, s.w)), s.w);
      const float4 hi = make_float4(bf16_round(sc.x), bf16_round(sc.y), bf16_round(sc.z), bf16_round(sc.w));
      hi_tile[threadIdx.x] = hi;
      lo_tile[threadIdx.x] = make_float4(bf16_round(sc.x - hi.x), bf16_round(sc.y - hi.y),
                                         bf16_round(sc.z - hi.z), bf16_round(sc.w - hi.w));
    } else if constexpr (P == Precision::kHyb) {
      const float x = p.x - cx, y = p.y - cy, z = p.z - cz;
      pos_tile[threadIdx.x] = make_float4(x, y, z, p.w);
      r2_tile[threadIdx.x] = __fadd_rn(dot3_rn(x, y, z, x, y, z), eps2);
    } else {
      m_tile[threadIdx.x] = __float2bfloat16_rn(p.w);
    }
    __syncthreads();

    if constexpr (P == Precision::kF32) {
      float tx = 0.f, ty = 0.f, tz = 0.f, tw = 0.f;
#pragma unroll 8
      for (int k = 0; k < kTile; ++k) {
        const float f = inv_cube(pos_tile[k], xi, yi, zi, eps2);
        const float4 s = hi_tile[k];
        tx = __fadd_rn(tx, __fmul_rn(f, s.x));
        ty = __fadd_rn(ty, __fmul_rn(f, s.y));
        tz = __fadd_rn(tz, __fmul_rn(f, s.z));
        tw = __fadd_rn(tw, __fmul_rn(f, s.w));
      }
      ox = __fadd_rn(ox, tx);
      oy = __fadd_rn(oy, ty);
      oz = __fadd_rn(oz, tz);
      ow = __fadd_rn(ow, tw);
    } else if constexpr (P == Precision::kFast) {
      // one partial a pass and a column; the products are exact, so each FMA
      // rounds as the product and then the sum would
      float4 hh = zero4, hl = zero4, lh = zero4;
#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        const float f = inv_cube(pos_tile[k], xi, yi, zi, eps2);
        const float fh = bf16_round(f);
        const float fl = bf16_round(f - fh);
        const float4 hi = hi_tile[k], lo = lo_tile[k];
        hh = make_float4(fmaf(fh, hi.x, hh.x), fmaf(fh, hi.y, hh.y), fmaf(fh, hi.z, hh.z), fmaf(fh, hi.w, hh.w));
        hl = make_float4(fmaf(fh, lo.x, hl.x), fmaf(fh, lo.y, hl.y), fmaf(fh, lo.z, hl.z), fmaf(fh, lo.w, hl.w));
        lh = make_float4(fmaf(fl, hi.x, lh.x), fmaf(fl, hi.y, lh.y), fmaf(fl, hi.z, lh.z), fmaf(fl, hi.w, lh.w));
      }
      // tmp = the three passes; out += tmp + (c sum f m, 0)
      const float tw = __fadd_rn(__fadd_rn(hh.w, hl.w), lh.w);
      ox = __fadd_rn(ox, __fadd_rn(__fadd_rn(__fadd_rn(hh.x, hl.x), lh.x), __fmul_rn(cx, tw)));
      oy = __fadd_rn(oy, __fadd_rn(__fadd_rn(__fadd_rn(hh.y, hl.y), lh.y), __fmul_rn(cy, tw)));
      oz = __fadd_rn(oz, __fadd_rn(__fadd_rn(__fadd_rn(hh.z, hl.z), lh.z), __fmul_rn(cz, tw)));
      ow = __fadd_rn(ow, tw);
    } else if constexpr (P == Precision::kHyb) {
      const float xic = xi - cx, yic = yi - cy, zic = zi - cz;
      const float ti2 = dot3_rn(xic, yic, zic, xic, yic, zic);
      float sx = 0.f, sy = 0.f, sz = 0.f, sw = 0.f;
#pragma unroll 8
      for (int k = 0; k < kTile; ++k) {
        const float4 q = pos_tile[k];
        const float cross = dot3_rn(xic, yic, zic, q.x, q.y, q.z);
        const float r2 = fmaxf(__fsub_rn(__fadd_rn(ti2, r2_tile[k]), __fmul_rn(2.f, cross)), eps2);
        const float inv = rsqrtf(r2);
        const float w = inv * inv * inv * q.w;
        sx = __fadd_rn(sx, __fmul_rn(w, q.x));
        sy = __fadd_rn(sy, __fmul_rn(w, q.y));
        sz = __fadd_rn(sz, __fmul_rn(w, q.z));
        sw = __fadd_rn(sw, w);
      }
      ox = __fadd_rn(ox, __fsub_rn(sx, __fmul_rn(xic, sw)));
      oy = __fadd_rn(oy, __fsub_rn(sy, __fmul_rn(yic, sw)));
      oz = __fadd_rn(oz, __fsub_rn(sz, __fmul_rn(zic, sw)));
    } else {
      float tx = 0.f, ty = 0.f, tz = 0.f;
#pragma unroll 8
      for (int k = 0; k < kTile; ++k) {
        const float4 q = pos_tile[k];
        const __nv_bfloat16 dx = __float2bfloat16_rn(q.x - xi);
        const __nv_bfloat16 dy = __float2bfloat16_rn(q.y - yi);
        const __nv_bfloat16 dz = __float2bfloat16_rn(q.z - zi);
        const float r2 = __bfloat162float(__hmul(dx, dx)) + __bfloat162float(__hmul(dy, dy)) +
                         __bfloat162float(__hmul(dz, dz)) + eps2;
        const float inv = rsqrtf(r2);
        const __nv_bfloat16 w = __hmul(__float2bfloat16_rn(inv * inv * inv), m_tile[k]);
        tx += __bfloat162float(__hmul(w, dx));
        ty += __bfloat162float(__hmul(w, dy));
        tz += __bfloat162float(__hmul(w, dz));
      }
      ox += tx;
      oy += ty;
      oz += tz;
    }
    __syncthreads();
  }
  if (i < nt) {
    if constexpr (P == Precision::kF32 || P == Precision::kFast) {
      ox = __fsub_rn(ox, __fmul_rn(xi, ow));
      oy = __fsub_rn(oy, __fmul_rn(yi, ow));
      oz = __fsub_rn(oz, __fmul_rn(zi, ow));
    }
    acc[3 * i + 0] = ox * g;
    acc[3 * i + 1] = oy * g;
    acc[3 * i + 2] = oz * g;
  }
}

template <Precision P>
int launch(const void* tgt, const void* src, const void* smat, void* acc, int nt, int ns, float g, float eps2,
           void* stream) {
  if (nt <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (nt + kThreads - 1) / kThreads;
  pairwise_precision_kernel<P><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tgt), static_cast<const float4*>(src), static_cast<const float4*>(smat),
      static_cast<float*>(acc), nt, ns, g, eps2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes, one a precision; each takes every
// pointer (smat null for hyb and bf16). Each launches on `stream` and returns
// the launch's cudaError_t (0 on success); none synchronises.
extern "C" int nbx_pairwise_f32(const void* tgt, const void* src, const void* smat, void* acc, int nt, int ns,
                                float g, float eps2, void* stream) {
  return launch<Precision::kF32>(tgt, src, smat, acc, nt, ns, g, eps2, stream);
}

extern "C" int nbx_pairwise_fast(const void* tgt, const void* src, const void* smat, void* acc, int nt, int ns,
                                 float g, float eps2, void* stream) {
  return launch<Precision::kFast>(tgt, src, smat, acc, nt, ns, g, eps2, stream);
}

extern "C" int nbx_pairwise_hyb(const void* tgt, const void* src, const void* smat, void* acc, int nt, int ns,
                                float g, float eps2, void* stream) {
  return launch<Precision::kHyb>(tgt, src, smat, acc, nt, ns, g, eps2, stream);
}

extern "C" int nbx_pairwise_bf16(const void* tgt, const void* src, const void* smat, void* acc, int nt, int ns,
                                 float g, float eps2, void* stream) {
  return launch<Precision::kBf16>(tgt, src, smat, acc, nt, ns, g, eps2, stream);
}
