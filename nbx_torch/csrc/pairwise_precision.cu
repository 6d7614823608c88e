// Softened direct-sum gravity at three study precisions of `pairwise_acc`,
// float32 in and out, for NVIDIA Hopper (sm_90a).
//
//   acc_i = G * sum_j m_j d_ij (|d_ij|^2 + eps^2)^(-3/2),   d_ij = p_j - p_i
//
// Replaces three TPU kernels of nbx/ops/pairwise.py, all behind
// `pairwise_acc` (call site :537), each with its own entry:
//
//   nbx_pairwise_f32   precision "f32"  `_acc_kernel` (:51)        K1a
//   nbx_pairwise_hyb   precision "hyb"  `_hyb_acc_kernel` (:302)   K1d
//   nbx_pairwise_bf16  precision "bf16" `_bf16_acc_kernel` (:400)  K1e
//
// ("fast", K1b, runs its products on the tensor cores: pairwise_fast.cu.)
// Each keeps its TPU kernel's formulation and its places of rounding and
// cancellation, which are the variant (the precision study of BASELINE
// config 4), not the TPU's blocks or matrix unit:
//
// - "f32": f = (|d|^2 + eps^2)^(-3/2) a pair, o = sum_j f S_j with the
//   mass-folded S = (m x, m y, m z, m), then o_xyz - p_i o_m once, at the end:
//   a cancellation over the whole source range.
// - "hyb": per source tile, r^2 by the centred identity |p_i - c|^2 +
//   |p_j - c|^2 - 2 (p_i - c).(p_j - c), all in float32 (on Hopper the 3-deep
//   cross term is three FP32 operations; TF32 would lose it), floored at
//   eps^2; w = m / r^3; the centred sums sum_j w (p_j - c) and sum_j w,
//   un-centred per tile as s - (p_i - c) sum_j w.
// - "bf16": d rounded to bf16; each of d d, f^3 m and w d a bf16 product
//   (never fused into an FMA); r^2 and the row sums in float32.
//
// Design of all three: K1's (csrc/pairwise_f32r.cu): 256 threads a block,
// each with kTargets = 4 targets in registers, so that a source's float4 in
// shared memory is read once for 4 targets; and a second grid dimension
// over the sources (split_sum.cuh), so that the drift gate's 16,384 targets
// (16 blocks of 1,024) still fill the card: 32 splits of 2 tiles, 512
// blocks. "f32" and "hyb" round where their plain versions round and sum in
// their order, so that the two agree bitwise: a cancellation amplifies any
// other rounding by |p| / |d|.
//
// "f32" reads a tile's positions and its mass-folded S (the wrapper builds
// S with torch ops), forms r^2 = fma(dz, dz, fma(dy, dy, fma(dx, dx,
// eps^2))) and f = (1 / r)^3, and sums each target's o = fma(f, S_j, o)
// over the tile's lanes in turn; each target's tile sums add to its split's
// running totals in turn, and `combine_splits<4>` adds the splits in turn,
// makes the cancellation o_xyz - p_i o_m (an FMUL and an FSUB, unfused, as
// the plain version rounds them) and multiplies by G.
//
// "hyb" forms per tile the centroid c (a halving tree over all 256 lanes,
// padding included, as the TPU kernel's mean over its padded tile), its
// targets' p_i - c and |p_i - c|^2, and sums the tile's lanes in turn; the
// tiles of a split add in turn, and `combine_splits<3>` adds the splits in
// turn and multiplies by G. Its centred source float4 and |p_j - c|^2 +
// eps^2 are formed once at the tile's load. The squares and the cross term are FMAs as in "mxu" (fma(z, z, fma(x,
// x, y y)), fma(z, z', fma(y, y', x x'))), and so are the three centred
// sums (s = fma(w, x - c, s)); the plain version (`_hyb_rows`) rounds them
// alike, so the two agree bitwise. rsqrt.approx.ftz alone replaces rsqrtf
// where eps^2 is normal (split_sum.cuh).
//
// "bf16" works on its 4 targets two by two, in packed bf16x2 registers (low
// half target t, high half t + 1): one F2FP (cvt.rn.bf16x2.f32) rounds the
// dx of two targets, one rounds their f^3, and one HMUL2 makes two of the
// products d d, f^3 m (m broadcast as bf16x2, formed once at the tile's
// load and kept in the float4's fourth lane) and w d. Each value rounds to
// nearest even as a scalar conversion or product would, so the products
// are bitwise those of one target a thread. Each product goes back to
// float32 by a shift (low half) or a mask (high half): r^2 = ((dx dx + dy
// dy) + dz dz) + eps^2 and the row sums, added lane after lane into a
// tile's partial and then into the split's totals; `combine_splits<3>` adds
// the splits. Nothing in "bf16" cancels, so its plain version sums in
// torch's order, within a few float32 roundings of the kernel.
//
// Bound: as K1, once a tile is in shared memory a pair costs no device-memory
// traffic; FP32 operations and one rsqrt a pair on the SFU bound the
// kernels (chip_smoke.py counts each term; "bf16"'s conversions too, by
// value, at the packed form's 124 a clock an SM that bench/cvt_rate.py
// measured: a quarter of its FP32 term). "f32" issues 3 differences, 3 FMAs for r^2, MUFU.RSQ, 2 FMULs for
// f and 4 FMAs for the sums, and 2 / kTargets shared loads a pair. "hyb"
// issues an FMUL and 2 FMAs for the cross term, an add and an FMA for r^2,
// the floor, MUFU.RSQ, 3 FMULs for w, 3 FMAs and an add for the sums, and 2
// / kTargets shared loads a pair (which nvcc merges to about 1.25 /
// kTargets). "bf16" issues 3 differences, 3 adds for r^2, MUFU.RSQ, 2 FMULs
// for f^3, 3 adds for the sums, 2 F2FP (4 values), 3.5 packed products
// (nvcc issues half as HMUL2, half as HFMA2.MMA), 6 unpacks on the integer
// pipe and 1 / kTargets shared loads a pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>

#include "mma_bf16.cuh"
#include "split_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = nbx_sum::kTile;
static_assert(kTile == kThreads, "one source a thread at the tile's load");
// targets a thread (ops/pairwise.py TARGETS): 4 over 2 measured 10.4%
// faster at 262,144 and 7% at 16,384 for "hyb", 2.5% and 4% for "bf16"
// (PERF.md).
constexpr int kTargets = 4;

// A half of a packed bf16x2 as float32, one integer instruction each: the
// low half shifted up, the high half masked (__low2float and __high2float
// spend two on the high half).
__device__ __forceinline__ float low_f(__nv_bfloat162 v) { return __uint_as_float(nbx_mma::bits(v) << 16); }
__device__ __forceinline__ float high_f(__nv_bfloat162 v) { return __uint_as_float(nbx_mma::bits(v) & 0xffff0000u); }

// "bf16": kTargets targets a thread, block (x, s) summing its kThreads x
// kTargets targets (target t of thread l: row x kThreads kTargets + t
// kThreads + l) against split s of the sources, into part[s, i, 0:3];
// targets t and t + 1 share packed registers.
template <bool kFtz>
__global__ void __launch_bounds__(kThreads)
pairwise_bf16_kernel(const float* __restrict__ tgt,   // [nt, 3]
                     const float4* __restrict__ src,  // [ns] (x, y, z, m)
                     float* __restrict__ part,        // [splits, nt, 3]
                     int nt, int ns, float eps2, int tiles_per_split) {
  static_assert(kTargets % 2 == 0, "targets in pairs");
  __shared__ float4 q_tile[kTile];  // (x, y, z, the bits of bf16x2 (m, m))
  const int i0 = blockIdx.x * kThreads * kTargets + threadIdx.x;
  float xi[kTargets], yi[kTargets], zi[kTargets];
  float ox[kTargets], oy[kTargets], oz[kTargets];  // the split's totals, before G
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = i0 + t * kThreads;
    xi[t] = i < nt ? tgt[3 * i + 0] : 0.f;
    yi[t] = i < nt ? tgt[3 * i + 1] : 0.f;
    zi[t] = i < nt ? tgt[3 * i + 2] : 0.f;
    ox[t] = oy[t] = oz[t] = 0.f;
  }
  const int2 range = nbx_sum::split_range(ns, tiles_per_split);
  for (int j0 = range.x; j0 < range.y; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    const float4 p = j < ns ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    q_tile[threadIdx.x] = make_float4(p.x, p.y, p.z, __uint_as_float(nbx_mma::bits(__float2bfloat162_rn(p.w))));
    __syncthreads();
    float tx[kTargets], ty[kTargets], tz[kTargets];
#pragma unroll
    for (int t = 0; t < kTargets; ++t) tx[t] = ty[t] = tz[t] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      const float4 q = q_tile[k];
      const __nv_bfloat162 m2 = nbx_mma::bf162(__float_as_uint(q.w));
#pragma unroll
      for (int a = 0; a < kTargets; a += 2) {
        const int b = a + 1;
        const __nv_bfloat162 dx = __floats2bfloat162_rn(q.x - xi[a], q.x - xi[b]);
        const __nv_bfloat162 dy = __floats2bfloat162_rn(q.y - yi[a], q.y - yi[b]);
        const __nv_bfloat162 dz = __floats2bfloat162_rn(q.z - zi[a], q.z - zi[b]);
        const __nv_bfloat162 xx = __hmul2(dx, dx), yy = __hmul2(dy, dy), zz = __hmul2(dz, dz);
        const float ia = nbx_sum::rsqrt_of<kFtz>(low_f(xx) + low_f(yy) + low_f(zz) + eps2);
        const float ib = nbx_sum::rsqrt_of<kFtz>(high_f(xx) + high_f(yy) + high_f(zz) + eps2);
        const __nv_bfloat162 w = __hmul2(__floats2bfloat162_rn(ia * ia * ia, ib * ib * ib), m2);
        const __nv_bfloat162 wx = __hmul2(w, dx), wy = __hmul2(w, dy), wz = __hmul2(w, dz);
        tx[a] += low_f(wx);
        ty[a] += low_f(wy);
        tz[a] += low_f(wz);
        tx[b] += high_f(wx);
        ty[b] += high_f(wy);
        tz[b] += high_f(wz);
      }
    }
#pragma unroll
    for (int t = 0; t < kTargets; ++t) {
      ox[t] += tx[t];
      oy[t] += ty[t];
      oz[t] += tz[t];
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.y) * nt * 3;
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = i0 + t * kThreads;
    if (i < nt) {
      out[3 * i + 0] = ox[t];
      out[3 * i + 1] = oy[t];
      out[3 * i + 2] = oz[t];
    }
  }
}

// "f32": kTargets targets a thread, block (x, s) summing its kThreads x
// kTargets targets (target t of thread l: row x kThreads kTargets + t
// kThreads + l) against split s of the sources, into part[s, i, 0:4] =
// (sum f m x, sum f m y, sum f m z, sum f m).
template <bool kFtz>
__global__ void __launch_bounds__(kThreads)
pairwise_f32_kernel(const float* __restrict__ tgt,    // [nt, 3]
                    const float4* __restrict__ src,   // [ns] (x, y, z, m)
                    const float4* __restrict__ smat,  // [ns] (m x, m y, m z, m)
                    float* __restrict__ part,         // [splits, nt, 4]
                    int nt, int ns, float eps2, int tiles_per_split) {
  __shared__ float4 p_tile[kTile];  // (x, y, z, m)
  __shared__ float4 s_tile[kTile];  // S
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int i0 = blockIdx.x * kThreads * kTargets + threadIdx.x;
  float xi[kTargets], yi[kTargets], zi[kTargets];
  float ox[kTargets], oy[kTargets], oz[kTargets], ow[kTargets];  // the split's totals
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = i0 + t * kThreads;
    xi[t] = i < nt ? tgt[3 * i + 0] : 0.f;
    yi[t] = i < nt ? tgt[3 * i + 1] : 0.f;
    zi[t] = i < nt ? tgt[3 * i + 2] : 0.f;
    ox[t] = oy[t] = oz[t] = ow[t] = 0.f;
  }
  const int2 range = nbx_sum::split_range(ns, tiles_per_split);
  for (int j0 = range.x; j0 < range.y; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    p_tile[threadIdx.x] = j < ns ? src[j] : zero4;
    s_tile[threadIdx.x] = j < ns ? smat[j] : zero4;
    __syncthreads();
    float tx[kTargets], ty[kTargets], tz[kTargets], tw[kTargets];
#pragma unroll
    for (int t = 0; t < kTargets; ++t) tx[t] = ty[t] = tz[t] = tw[t] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      const float4 q = p_tile[k];
      const float4 s = s_tile[k];
#pragma unroll
      for (int t = 0; t < kTargets; ++t) {
        const float dx = __fsub_rn(q.x, xi[t]), dy = __fsub_rn(q.y, yi[t]), dz = __fsub_rn(q.z, zi[t]);
        const float inv = nbx_sum::rsqrt_of<kFtz>(__fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, eps2))));
        const float f = __fmul_rn(__fmul_rn(inv, inv), inv);
        tx[t] = __fmaf_rn(f, s.x, tx[t]);
        ty[t] = __fmaf_rn(f, s.y, ty[t]);
        tz[t] = __fmaf_rn(f, s.z, tz[t]);
        tw[t] = __fmaf_rn(f, s.w, tw[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kTargets; ++t) {
      ox[t] = __fadd_rn(ox[t], tx[t]);
      oy[t] = __fadd_rn(oy[t], ty[t]);
      oz[t] = __fadd_rn(oz[t], tz[t]);
      ow[t] = __fadd_rn(ow[t], tw[t]);
    }
    __syncthreads();
  }
  float4* out = reinterpret_cast<float4*>(part + static_cast<size_t>(blockIdx.y) * nt * 4);
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = i0 + t * kThreads;
    if (i < nt) out[i] = make_float4(ox[t], oy[t], oz[t], ow[t]);
  }
}

template <bool kFtz>
int launch_f32(const float* tgt, const float4* src, const float4* smat, float* part, float* acc, int nt, int ns,
               float g, float eps2, int tiles_per_split, cudaStream_t stream) {
  const int splits = nbx_sum::split_count(ns, tiles_per_split);
  const dim3 grid((nt + kThreads * kTargets - 1) / (kThreads * kTargets), splits);
  pairwise_f32_kernel<kFtz><<<grid, kThreads, 0, stream>>>(tgt, src, smat, part, nt, ns, eps2, tiles_per_split);
  nbx_sum::combine<4>(part, tgt, acc, nt, splits, g, stream);
  return static_cast<int>(cudaGetLastError());
}

// "hyb": kTargets targets a thread, block (x, s) summing its kThreads x
// kTargets targets (target t of thread l: row x kThreads kTargets + t
// kThreads + l) against split s of the sources, into part[s, i, 0:3]. Each
// tile's centred sources (x - c, y - c, z - c, m) and |p_j - c|^2 + eps^2
// are read from shared memory once for the thread's kTargets targets.
template <bool kFtz>
__global__ void __launch_bounds__(kThreads)
pairwise_hyb_kernel(const float* __restrict__ tgt,   // [nt, 3]
                    const float4* __restrict__ src,  // [ns] (x, y, z, m)
                    float* __restrict__ part,        // [splits, nt, 3]
                    int nt, int ns, float eps2, int tiles_per_split) {
  __shared__ float4 q_tile[kTile];  // (x - c, y - c, z - c, m)
  __shared__ float tj2_tile[kTile];  // |p_j - c|^2 + eps^2
  __shared__ float3 red[kTile], mean;
  const int i0 = blockIdx.x * kThreads * kTargets + threadIdx.x;
  float ox[kTargets], oy[kTargets], oz[kTargets];  // the split's totals, before G
#pragma unroll
  for (int t = 0; t < kTargets; ++t) ox[t] = oy[t] = oz[t] = 0.f;
  const int2 range = nbx_sum::split_range(ns, tiles_per_split);
  for (int j0 = range.x; j0 < range.y; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    const float4 p = j < ns ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float3 c = nbx_sum::tree_mean(make_float3(p.x, p.y, p.z), red, &mean);
    {
      const float x = p.x - c.x, y = p.y - c.y, z = p.z - c.z;
      q_tile[threadIdx.x] = make_float4(x, y, z, p.w);
      tj2_tile[threadIdx.x] = __fadd_rn(nbx_sum::square3(x, y, z), eps2);
    }
    __syncthreads();

    // p_i - c and |p_i - c|^2 of each target (rows past nt: the origin's,
    // computed and never stored); the tile's centred sums
    float xic[kTargets], yic[kTargets], zic[kTargets], ti2[kTargets];
    float sx[kTargets], sy[kTargets], sz[kTargets], sw[kTargets];
#pragma unroll
    for (int t = 0; t < kTargets; ++t) {
      const int i = i0 + t * kThreads;
      xic[t] = (i < nt ? tgt[3 * i + 0] : 0.f) - c.x;
      yic[t] = (i < nt ? tgt[3 * i + 1] : 0.f) - c.y;
      zic[t] = (i < nt ? tgt[3 * i + 2] : 0.f) - c.z;
      ti2[t] = nbx_sum::square3(xic[t], yic[t], zic[t]);
      sx[t] = sy[t] = sz[t] = sw[t] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      const float4 q = q_tile[k];
      const float tj2 = tj2_tile[k];
#pragma unroll
      for (int t = 0; t < kTargets; ++t) {
        const float cross = nbx_sum::cross3(xic[t], yic[t], zic[t], q.x, q.y, q.z);
        // (ti2 + tj2) - 2 cross: 2 cross is exact, so one FMA rounds as the
        // product and then the difference would
        const float r2 = fmaxf(__fmaf_rn(-2.f, cross, __fadd_rn(ti2[t], tj2)), eps2);
        const float inv = nbx_sum::rsqrt_of<kFtz>(r2);
        const float w = inv * inv * inv * q.w;
        sx[t] = __fmaf_rn(w, q.x, sx[t]);
        sy[t] = __fmaf_rn(w, q.y, sy[t]);
        sz[t] = __fmaf_rn(w, q.z, sz[t]);
        sw[t] = __fadd_rn(sw[t], w);
      }
    }
#pragma unroll
    for (int t = 0; t < kTargets; ++t) {
      ox[t] = __fadd_rn(ox[t], __fsub_rn(sx[t], __fmul_rn(xic[t], sw[t])));
      oy[t] = __fadd_rn(oy[t], __fsub_rn(sy[t], __fmul_rn(yic[t], sw[t])));
      oz[t] = __fadd_rn(oz[t], __fsub_rn(sz[t], __fmul_rn(zic[t], sw[t])));
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.y) * nt * 3;
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = i0 + t * kThreads;
    if (i < nt) {
      out[3 * i + 0] = ox[t];
      out[3 * i + 1] = oy[t];
      out[3 * i + 2] = oz[t];
    }
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes, one a precision. Each takes
// `part`, [splits, nt, 4] ("f32") or [splits, nt, 3] float32 scratch,
// splits = ceil(ceil(ns / 256) / tiles_per_split) (at least 1), launches
// the split sum and the combine on `stream` and returns the launches'
// cudaError_t (0 on success); none synchronises. Each takes MUFU.RSQ alone
// where eps^2 is a normal float32, rsqrtf below.
extern "C" int nbx_pairwise_bf16(const void* tgt, const void* src, void* part, void* acc, int nt, int ns, float g,
                                 float eps2, int tiles_per_split, void* stream) {
  return nbx_sum::launch3(eps2 >= FLT_MIN ? pairwise_bf16_kernel<true> : pairwise_bf16_kernel<false>,
                          kThreads * kTargets, tgt, src, part, acc, nt, ns, g, eps2, tiles_per_split, stream);
}

extern "C" int nbx_pairwise_f32(const void* tgt, const void* src, const void* smat, void* part, void* acc, int nt,
                                int ns, float g, float eps2, int tiles_per_split, void* stream) {
  if (nt <= 0) return static_cast<int>(cudaSuccess);
  if (tiles_per_split <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(tgt);
  const auto* s = static_cast<const float4*>(src);
  const auto* m = static_cast<const float4*>(smat);
  auto* p = static_cast<float*>(part);
  auto* a = static_cast<float*>(acc);
  const auto st = static_cast<cudaStream_t>(stream);
  return eps2 >= FLT_MIN ? launch_f32<true>(t, s, m, p, a, nt, ns, g, eps2, tiles_per_split, st)
                         : launch_f32<false>(t, s, m, p, a, nt, ns, g, eps2, tiles_per_split, st);
}

extern "C" int nbx_pairwise_hyb(const void* tgt, const void* src, void* part, void* acc, int nt, int ns, float g,
                                float eps2, int tiles_per_split, void* stream) {
  return nbx_sum::launch3(eps2 >= FLT_MIN ? pairwise_hyb_kernel<true> : pairwise_hyb_kernel<false>,
                          kThreads * kTargets, tgt, src, part, acc, nt, ns, g, eps2, tiles_per_split, stream);
}
