// Softened direct-sum gravity at precision "fast", float32 in and out, its
// bf16 products on Hopper's tensor cores (sm_90a, mma.sync).
//
//   acc_i = G * sum_j m_j d_ij (|d_ij|^2 + eps^2)^(-3/2),   d_ij = p_j - p_i
//
// Replaces the TPU kernel `_fast_acc_kernel` of nbx/ops/pairwise.py (:93),
// behind `pairwise_acc` (call site :537) at precision "fast": K1b. Its
// formulation, per source tile with centroid c (the mean over every lane of
// the tile, padding included):
//
//   f    = (|p_j - p_i|^2 + eps^2)^(-3/2), by direct differences, float32;
//   s_c  = (m (x - c), m (y - c), m (z - c), m): the mass-folded S centred,
//          S - (c m, 0), formed from the wrapper's S = (m x, m y, m z, m);
//   tmp  = (f_hi s_hi + f_hi s_lo) + f_lo s_hi, hi = bf16(v), lo = bf16(v -
//          hi): three bf16 products summed in float32 (the TPU's matrix unit;
//          here the tensor cores);
//   o   += tmp + (c tmp_w, 0), tile after tile;
//   acc  = G (o_xyz - p_i o_w): the cancellation over the whole source range.
//
// Design: a warp owns 16 targets (the MMA's M), 8 warps a block, so a block
// holds 128 targets; a second grid dimension splits the sources into runs
// of whole tiles (split_sum.cuh), so that the drift gate's 16,384 targets
// (128 blocks) fill the card as 512. The sources come in tiles of 256, one
// a thread at the load, where the tile forms its centroid (a halving tree,
// as the plain version sums it), s_c, and the B operand of
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 for every 16-source
// chunk: 8 columns [s_hi (4) | s_lo (4)], stored column by column, so that
// one MMA gives both f_hi s_hi and f_hi s_lo. For each chunk each lane
// computes on the CUDA cores the 8 values of f that sit in its A fragment
// (mma_bf16.cuh), r^2 rounded as the plain version rounds it, splits them
// into bf16 hi and lo (an F2FP packs two), and issues two MMAs from zero:
// f_hi [s_hi | s_lo] into C1 and f_lo [s_hi | s_lo] into C2, whose columns
// 4-7 (f_lo s_lo, which the formulation drops) are never read. Each lane
// adds C1 and C2 to the tile's float32 sums S1 and S2, chunk after chunk.
// At the tile's end the lanes that hold columns 0-3 add S1's columns 4-7
// from two lanes to the right, then S2, and add tmp + (c tmp_w, 0) to their
// running totals; the lane holding x and y of a row takes that row's tmp_w
// from the lane to its right. Each split writes its totals (o_xyz, o_w) to
// part[s, i, 0:4]; `combine_splits` adds the splits in turn, cancels and
// multiplies by G. Source lanes past Ns load position 0 and mass 0, as the
// TPU kernel's padding lanes; target rows past Nt compute and store nothing.
//
// The tensor cores sum each chunk's 16 products in an order of their own,
// with an accumulator that truncates where an add rounds, so the kernel
// agrees with its plain version (`_fast_rows`) to the roundings of those
// sums and not bitwise. Starting each chunk's MMAs from zero keeps that to
// one chunk, as in "mxu". Where a target is a source, its self pair's f m_i
// x_i cancels in o_xyz - p_i o_w, and that difference reaches a few ulps of
// it (chip_smoke.py states the bars).
//
// Bound: once a tile is in shared memory a pair costs no device-memory
// traffic. Per pair, 13 FP32 operations (3 differences, r^2 + eps^2 6, f 2,
// f - hi 1, the tile's sums 1), one rsqrt on the SFU (rsqrt.approx.ftz
// alone where eps^2 is normal), one F2FP that packs two values' hi or lo
// (conversions run 16 a clock an SM, as the SFU: the two tie for the bound)
// and 1/128 of a warp's MMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "mma_bf16.cuh"
#include "split_sum.cuh"

namespace {

using nbx_sum::kTile;

constexpr int kThreads = kTile;                   // 8 warps, one source a thread at the load
constexpr int kWarpRows = 16;                     // targets a warp: the MMA's M
constexpr int kRows = kThreads / 32 * kWarpRows;  // targets a block
constexpr int kChunk = 16;                        // sources an MMA: its K
constexpr int kCols = 8;                          // the MMA's N: [s_hi | s_lo]
constexpr int kPitch = kTile + 8;                 // bf16 a B column: + 8 puts the 8 columns in distinct banks

// (|q - p|^2 + eps^2)^(-3/2), r^2 = (dx dx + dy dy) + dz dz + eps^2 rounded
// in turn, as the plain version sums it.
template <bool kFtz>
__device__ __forceinline__ float inv_cube(float4 q, float3 p, float eps2) {
  const float dx = q.x - p.x, dy = q.y - p.y, dz = q.z - p.z;
  const float r2 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)), eps2);
  const float inv = nbx_sum::rsqrt_of<kFtz>(r2);
  return inv * inv * inv;
}

template <bool kFtz>
__global__ void __launch_bounds__(kThreads)
pairwise_fast_kernel(const float* __restrict__ tgt,    // [nt, 3]
                     const float4* __restrict__ src,   // [ns] (x, y, z, m)
                     const float4* __restrict__ smat,  // [ns] (m x, m y, m z, m)
                     float* __restrict__ part,         // [splits, nt, 4]
                     int nt, int ns, float eps2, int tiles_per_split) {
  __shared__ float4 pos_tile[kTile];                             // (x, y, z, m)
  __shared__ __align__(16) __nv_bfloat16 b_tile[kCols][kPitch];  // B by column: s_hi, s_lo
  __shared__ float3 red[kTile], mean;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2, quad = lane & 3;  // the fragments' row group and column pair
  // this lane's two targets: rows grp and grp + 8 of its warp's 16
  const int i0 = blockIdx.x * kRows + (threadIdx.x >> 5) * kWarpRows + grp;
  const int i1 = i0 + 8;
  float3 pa = make_float3(0.f, 0.f, 0.f), pb = pa;
  if (i0 < nt) pa = make_float3(tgt[3 * i0], tgt[3 * i0 + 1], tgt[3 * i0 + 2]);
  if (i1 < nt) pb = make_float3(tgt[3 * i1], tgt[3 * i1 + 1], tgt[3 * i1 + 2]);
  // Running totals over the split's tiles of columns 2 quad and 2 quad + 1
  // of rows grp (oa) and grp + 8 (ob): quad 0 keeps (x, y), quad 1 (z, w);
  // quads 2 and 3 keep nothing.
  float oa0 = 0.f, oa1 = 0.f, ob0 = 0.f, ob1 = 0.f;
  const int2 range = nbx_sum::split_range(ns, tiles_per_split);
  for (int j0 = range.x; j0 < range.y; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    const float4 p = j < ns ? src[j] : zero4;
    const float3 c = nbx_sum::tree_mean(make_float3(p.x, p.y, p.z), red, &mean);
    pos_tile[threadIdx.x] = p;
    {
      const float4 s = j < ns ? smat[j] : zero4;
      const float v[4] = {__fsub_rn(s.x, __fmul_rn(c.x, s.w)), __fsub_rn(s.y, __fmul_rn(c.y, s.w)),
                          __fsub_rn(s.z, __fmul_rn(c.z, s.w)), s.w};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const __nv_bfloat16 hi = __float2bfloat16_rn(v[n]);
        b_tile[n][threadIdx.x] = hi;
        b_tile[4 + n][threadIdx.x] = __float2bfloat16_rn(__fsub_rn(v[n], __bfloat162float(hi)));
      }
    }
    __syncthreads();

    float sum1[4] = {0.f, 0.f, 0.f, 0.f}, sum2[4] = {0.f, 0.f, 0.f, 0.f};  // S1, S2
#pragma unroll 2
    for (int k0 = 0; k0 < kTile; k0 += kChunk) {
      const int ka = k0 + 2 * quad, kb = ka + 8;  // this lane's sources ka, ka + 1, kb, kb + 1
      const float4 q0 = pos_tile[ka], q1 = pos_tile[ka + 1], q2 = pos_tile[kb], q3 = pos_tile[kb + 1];
      uint32_t h0, l0, h1, l1, h2, l2, h3, l3;
      nbx_mma::split2(inv_cube<kFtz>(q0, pa, eps2), inv_cube<kFtz>(q1, pa, eps2), h0, l0);  // row grp, ka, ka + 1
      nbx_mma::split2(inv_cube<kFtz>(q0, pb, eps2), inv_cube<kFtz>(q1, pb, eps2), h1, l1);  // row grp + 8
      nbx_mma::split2(inv_cube<kFtz>(q2, pa, eps2), inv_cube<kFtz>(q3, pa, eps2), h2, l2);  // row grp, kb, kb + 1
      nbx_mma::split2(inv_cube<kFtz>(q2, pb, eps2), inv_cube<kFtz>(q3, pb, eps2), h3, l3);  // row grp + 8
      // B: column grp, sources (rows) ka, ka + 1 and kb, kb + 1
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&b_tile[grp][ka]);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&b_tile[grp][kb]);
      float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
      nbx_mma::mma_bf16(c1, h0, h1, h2, h3, b0, b1);
      nbx_mma::mma_bf16(c2, l0, l1, l2, l3, b0, b1);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sum1[r] = __fadd_rn(sum1[r], c1[r]);
        sum2[r] = __fadd_rn(sum2[r], c2[r]);
      }
    }
    // tmp = (f_hi s_hi + f_hi s_lo) + f_lo s_hi; f_hi s_lo's columns of S1
    // sit two lanes to the right of f_hi s_hi's
    float tmp[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      tmp[r] = __fadd_rn(__fadd_rn(sum1[r], __shfl_down_sync(0xffffffffu, sum1[r], 2)), sum2[r]);
    }
    // tmp_w of rows grp and grp + 8: column 3, in quad 1's second register
    const int w_lane = (lane & ~3) | 1;
    const float wa = __shfl_sync(0xffffffffu, tmp[1], w_lane);
    const float wb = __shfl_sync(0xffffffffu, tmp[3], w_lane);
    if (quad == 0) {
      oa0 = __fadd_rn(oa0, __fadd_rn(tmp[0], __fmul_rn(c.x, wa)));
      oa1 = __fadd_rn(oa1, __fadd_rn(tmp[1], __fmul_rn(c.y, wa)));
      ob0 = __fadd_rn(ob0, __fadd_rn(tmp[2], __fmul_rn(c.x, wb)));
      ob1 = __fadd_rn(ob1, __fadd_rn(tmp[3], __fmul_rn(c.y, wb)));
    } else if (quad == 1) {
      oa0 = __fadd_rn(oa0, __fadd_rn(tmp[0], __fmul_rn(c.z, wa)));
      oa1 = __fadd_rn(oa1, wa);
      ob0 = __fadd_rn(ob0, __fadd_rn(tmp[2], __fmul_rn(c.z, wb)));
      ob1 = __fadd_rn(ob1, wb);
    }
    __syncthreads();
  }
  if (quad < 2) {
    float* out = part + static_cast<size_t>(blockIdx.y) * nt * 4 + 2 * quad;
    if (i0 < nt) *reinterpret_cast<float2*>(out + 4 * i0) = make_float2(oa0, oa1);
    if (i1 < nt) *reinterpret_cast<float2*>(out + 4 * i1) = make_float2(ob0, ob1);
  }
}

template <bool kFtz>
int launch(const float* tgt, const float4* src, const float4* smat, float* part, float* acc, int nt, int ns,
           float g, float eps2, int tiles_per_split, cudaStream_t stream) {
  const int splits = nbx_sum::split_count(ns, tiles_per_split);
  const dim3 grid((nt + kRows - 1) / kRows, splits);
  pairwise_fast_kernel<kFtz><<<grid, kThreads, 0, stream>>>(tgt, src, smat, part, nt, ns, eps2, tiles_per_split);
  nbx_sum::combine<4>(part, tgt, acc, nt, splits, g, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes: `smat` is the wrapper's S, `part`
// [splits, nt, 4] float32 scratch, splits = ceil(ceil(ns / 256) /
// tiles_per_split) (at least 1). Launches on `stream` and returns the
// launch's cudaError_t (0 on success); does not synchronise.
extern "C" int nbx_pairwise_fast(const void* tgt, const void* src, const void* smat, void* part, void* acc, int nt,
                                 int ns, float g, float eps2, int tiles_per_split, void* stream) {
  if (nt <= 0) return static_cast<int>(cudaSuccess);
  if (tiles_per_split <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(tgt);
  const auto* s = static_cast<const float4*>(src);
  const auto* m = static_cast<const float4*>(smat);
  auto* p = static_cast<float*>(part);
  auto* a = static_cast<float*>(acc);
  const auto st = static_cast<cudaStream_t>(stream);
  return eps2 >= FLT_MIN ? launch<true>(t, s, m, p, a, nt, ns, g, eps2, tiles_per_split, st)
                         : launch<false>(t, s, m, p, a, nt, ns, g, eps2, tiles_per_split, st);
}
