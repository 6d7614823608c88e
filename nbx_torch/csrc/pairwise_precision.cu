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
// Design of "bf16": one thread per target, 256 threads a block, the sources
// in tiles of 256 loaded cooperatively into shared memory, each tile summed
// into a partial that is then added to the running total, ragged edges
// masked here (source lanes past Ns load position 0 and mass 0, as the TPU
// kernel's padding lanes; target threads past Nt store nothing).
//
// Design of "f32" and "hyb": K1's (csrc/pairwise_f32r.cu): 256 threads a
// block, each with kTargets = 4 targets in registers, so that a source's
// float4s in shared memory are read once for 4 targets; and a second grid
// dimension over the sources (split_sum.cuh), so that the drift gate's
// 16,384 targets (16 blocks of 1,024) still fill the card: 32 splits of 2
// tiles, 512 blocks. Each rounds where its plain version rounds and sums in
// its order, so that the two agree bitwise: a cancellation amplifies any
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
// Bound: as K1, once a tile is in shared memory a pair costs no device-memory
// traffic; FP32 operations, one rsqrt a pair on the SFU and, for "bf16",
// float32-to-bf16 conversions (16 a clock an SM, as the SFU) bound the
// kernels: chip_smoke.py counts each term. "f32" issues 3 differences, 3
// FMAs for r^2, MUFU.RSQ, 2 FMULs for f and 4 FMAs for the sums, and 2 /
// kTargets shared loads a pair. "hyb" issues an FMUL and 2 FMAs for the
// cross term, an add and an FMA for r^2, the floor, MUFU.RSQ, 3 FMULs for
// w, 3 FMAs and an add for the sums, and 2 / kTargets shared loads a pair
// (which nvcc merges to about 1.25 / kTargets).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>

#include "split_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = nbx_sum::kTile;
static_assert(kTile == kThreads, "one source a thread at the tile's load");
// targets a thread of "f32" and "hyb" (ops/pairwise.py TARGETS): 4 over 2
// measured 10.4% faster at 262,144 and 7% at 16,384 for "hyb" (PERF.md).
constexpr int kTargets = 4;

// "bf16": one thread a target.
__global__ void __launch_bounds__(kThreads)
pairwise_bf16_kernel(const float* __restrict__ tgt,   // [nt, 3]
                     const float4* __restrict__ src,  // [ns] (x, y, z, m)
                     float* __restrict__ acc,         // [nt, 3]
                     int nt, int ns, float g, float eps2) {
  __shared__ float4 pos_tile[kTile];       // (x, y, z, m)
  __shared__ __nv_bfloat16 m_tile[kTile];  // bf16(m)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (i < nt) {
    xi = tgt[3 * i + 0];
    yi = tgt[3 * i + 1];
    zi = tgt[3 * i + 2];
  }
  float ox = 0.f, oy = 0.f, oz = 0.f;  // the acceleration before G
  for (int j0 = 0; j0 < ns; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    const float4 p = j < ns ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    pos_tile[threadIdx.x] = p;
    m_tile[threadIdx.x] = __float2bfloat16_rn(p.w);
    __syncthreads();
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
    __syncthreads();
  }
  if (i < nt) {
    acc[3 * i + 0] = ox * g;
    acc[3 * i + 1] = oy * g;
    acc[3 * i + 2] = oz * g;
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

template <bool kFtz>
int launch_hyb(const float* tgt, const float4* src, float* part, float* acc, int nt, int ns, float g, float eps2,
               int tiles_per_split, cudaStream_t stream) {
  const int splits = nbx_sum::split_count(ns, tiles_per_split);
  const dim3 grid((nt + kThreads * kTargets - 1) / (kThreads * kTargets), splits);
  pairwise_hyb_kernel<kFtz><<<grid, kThreads, 0, stream>>>(tgt, src, part, nt, ns, eps2, tiles_per_split);
  nbx_sum::combine<3>(part, tgt, acc, nt, splits, g, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes, one a precision. Each launches
// on `stream` and returns the launches' cudaError_t (0 on success); none
// synchronises. The split sums ("f32", "hyb") take `part`, [splits, nt, 4]
// or [splits, nt, 3] float32 scratch, splits = ceil(ceil(ns / 256) /
// tiles_per_split) (at least 1), launch the split sum and the combine, and
// take MUFU.RSQ alone where eps^2 is a normal float32, rsqrtf below.
extern "C" int nbx_pairwise_bf16(const void* tgt, const void* src, void* acc, int nt, int ns, float g, float eps2,
                                 void* stream) {
  if (nt <= 0) return static_cast<int>(cudaSuccess);
  pairwise_bf16_kernel<<<(nt + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tgt), static_cast<const float4*>(src), static_cast<float*>(acc), nt, ns, g, eps2);
  return static_cast<int>(cudaGetLastError());
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
  if (nt <= 0) return static_cast<int>(cudaSuccess);
  if (tiles_per_split <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(tgt);
  const auto* s = static_cast<const float4*>(src);
  auto* p = static_cast<float*>(part);
  auto* a = static_cast<float*>(acc);
  const auto st = static_cast<cudaStream_t>(stream);
  return eps2 >= FLT_MIN ? launch_hyb<true>(t, s, p, a, nt, ns, g, eps2, tiles_per_split, st)
                         : launch_hyb<false>(t, s, p, a, nt, ns, g, eps2, tiles_per_split, st);
}
