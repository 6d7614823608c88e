// Softened direct-sum gravity at precision "mxu", float32 in and out, its
// bf16 products on Hopper's tensor cores (sm_90a, mma.sync).
//
//   acc_i = G * sum_j m_j d_ij (|d_ij|^2 + eps^2)^(-3/2),   d_ij = p_j - p_i
//
// Replaces the TPU kernel `_mxu_acc_kernel` of nbx/ops/pairwise.py (:200),
// behind `pairwise_acc` (call site :537) at precision "mxu": K1c. Its
// formulation, per source tile with centroid c (the mean over every lane of
// the tile, padding included):
//
//   r^2  = ((|p_i - c|^2 + |p_j - c|^2) - 2 (p_i - c).(p_j - c)) + eps^2,
//          floored at eps^2, all float32 on the CUDA cores (TF32 would lose
//          the cross term);
//   w    = m_j / r^3;
//   tmp  = (w_hi P_hi + w_hi P_lo) + w_lo P_hi over P_c = (p_j - c, 1),
//          hi = bf16(v), lo = bf16(v - hi): three bf16 products summed in
//          float32 (the TPU's matrix unit; here the tensor cores);
//   acc += tmp_xyz - (p_i - c) tmp_w, tile after tile, times G at the end.
//
// Roundings: the centroid sums its lanes in blocks of 32, each in lane
// order, then the blocks in order; the squares are fma(z, z, fma(x, x, y y))
// and the cross term fma(z, z', fma(y, y', x x')). That is how XLA's CPU
// backend runs the JAX kernel, so the plain version (`_mxu_rows`) can hold
// both to one rounding: a self pair's cancelling term follows these last
// bits (its bf16 splits of w_ii and of p_i - c).
//
// Design: a warp owns 16 targets (the MMA's M), 8 warps a block, so a block
// holds 128 targets. The sources come in tiles of 256, one a thread at the
// load, where the tile forms its centroid (warp 0: lane b < 8 sums block b,
// lane 0 then the blocks), its centred sources and |p_j - c|^2, and the B
// operand of
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 for every 16-source
// chunk: 8 columns [P_hi (4) | P_lo (4)], stored column by column, so that
// one MMA gives both w_hi P_hi and w_hi P_lo. For each chunk each lane
// computes the 8 weights that sit in its A fragment (targets l/4 and
// l/4 + 8, sources 2 (l%4) + {0, 1} and + 8) on the CUDA cores, rounding
// each product and sum where the plain version does (`__fmul_rn`,
// `__fadd_rn`, `__fmaf_rn`: no other contraction), splits them into bf16
// hi and lo, and issues two MMAs from zero: w_hi [P_hi | P_lo] into C1 and
// w_lo [P_hi | P_lo] into C2, whose columns 4-7 (w_lo P_lo, which the
// formulation drops) are never read. Each lane adds C1 and C2 to the
// tile's float32 sums S1 and S2, chunk after chunk. At the tile's end the
// lanes that hold columns 0-3 add S1's columns 4-7 from two lanes to the
// right, then S2, and un-centre into their running totals; the lane
// holding x and y of a row takes that row's tmp_w from the lane to its
// right. Source lanes past Ns load position 0 and mass
// 0, as the TPU kernel's padding lanes; target rows past Nt compute and
// store nothing.
//
// The tensor cores sum each chunk's 16 products in an order of their own,
// and with an accumulator that truncates where an add rounds, so the kernel
// agrees with its plain version to the roundings of those sums and not
// bitwise. Starting each chunk's MMAs from zero keeps that to one chunk: an
// MMA that accumulated a whole tile would truncate at the tile's magnitude
// 16 times, a bias that the cancelling un-centring amplifies. Where a target is a source,
// the self pair's term cancels in tmp_xyz - (p_i - c) tmp_w and that
// difference reaches a few ulps of the term (chip_smoke.py states the bars).
//
// Bound: as K1, once a tile is in shared memory a pair costs no device-memory
// traffic. Per pair, about 14 FP32 operations (the cross term 5, r^2 4, w 3,
// w - hi 1, the tile's sums 1), one rsqrtf on the SFU, one F2FP that packs w's hi and lo
// (conversions run 16 a clock an SM, as the SFU; chip_smoke.py counts each
// term, and the SFU and the conversions tie for the bound) and 1/128 of a
// warp's MMA, whose FLOPs are a few percent of the tensor cores' rate.
// Speed work (wgmma, TMA, several target tiles a warp) is for later
// changes; this version is the simple, correct one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"
#include "split_sum.cuh"

namespace {

using nbx_mma::mma_bf16;
using nbx_mma::split2;
using nbx_sum::cross3;
using nbx_sum::square3;

constexpr int kThreads = 256;                  // 8 warps
constexpr int kTile = kThreads;                // sources a tile, one a thread at the load
constexpr int kWarpRows = 16;                  // targets a warp: the MMA's M
constexpr int kRows = kThreads / 32 * kWarpRows;  // targets a block
constexpr int kChunk = 16;                     // sources an MMA: its K
constexpr int kCols = 8;                       // the MMA's N: [P_hi | P_lo]
constexpr int kPitch = kTile + 8;              // bf16 a B column: + 8 puts the 8 columns in distinct banks

__device__ __forceinline__ float3 add3(float3 a, float3 b) {
  return make_float3(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z));
}

constexpr int kBlock = 32;                       // lanes a block of the centroid's sum
constexpr int kRedPitch = kBlock + 1;            // + 1: the blocks' lanes k in distinct banks

// The tile's centroid: the mean of v over all kTile lanes, padding lanes
// included, summed as the plain version sums it: lane b < kTile / 32 of
// warp 0 adds block b's 32 lanes in order, lane 0 then the blocks' sums in
// order. Every thread of the block gets it; every thread must call it.
__device__ __forceinline__ float3 tile_mean(float3 v, float3* red, float3* mean) {
  const int t = threadIdx.x;
  red[(t / kBlock) * kRedPitch + t % kBlock] = v;
  __syncthreads();
  if (t < 32) {
    float3 s = make_float3(0.f, 0.f, 0.f);
    if (t < kTile / kBlock) {
      const float3* blk = red + t * kRedPitch;
      s = blk[0];
      for (int k = 1; k < kBlock; ++k) s = add3(s, blk[k]);
    }
    float3 total = s;
    for (int b = 1; b < kTile / kBlock; ++b) {
      total = add3(total, make_float3(__shfl_sync(0xffffffffu, s.x, b), __shfl_sync(0xffffffffu, s.y, b),
                                      __shfl_sync(0xffffffffu, s.z, b)));
    }
    if (t == 0) *mean = make_float3(total.x * (1.f / kTile), total.y * (1.f / kTile), total.z * (1.f / kTile));
  }
  __syncthreads();
  return *mean;
}

struct Target {
  float x, y, z, t2;  // p_i - c and |p_i - c|^2
};

// w = m_j / r^3 of one pair, r^2 rounded as the plain version rounds it.
__device__ __forceinline__ float weight(const Target& t, float4 q, float tj2, float eps2) {
  const float cross = cross3(t.x, t.y, t.z, q.x, q.y, q.z);
  const float r2 = fmaxf(__fadd_rn(__fsub_rn(__fadd_rn(t.t2, tj2), __fmul_rn(2.f, cross)), eps2), eps2);
  const float inv = rsqrtf(r2);
  return inv * inv * inv * q.w;
}

__global__ void __launch_bounds__(kThreads)
pairwise_mxu_kernel(const float* __restrict__ tgt,   // [nt, 3]
                    const float4* __restrict__ src,  // [ns] (x, y, z, m)
                    float* __restrict__ acc,         // [nt, 3]
                    int nt, int ns, float g, float eps2) {
  __shared__ float4 q_tile[kTile];                         // (x - c, y - c, z - c, m)
  __shared__ float tj2_tile[kTile];                        // |p_j - c|^2
  __shared__ __align__(16) __nv_bfloat16 b_tile[kCols][kPitch];  // B by column: P_hi (x, y, z, 1), P_lo
  __shared__ float3 red[kTile / kBlock * kRedPitch], mean;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2, quad = lane & 3;  // the fragments' row group and column pair
  // this lane's two targets: rows grp and grp + 8 of its warp's 16
  const int i0 = blockIdx.x * kRows + (threadIdx.x >> 5) * kWarpRows + grp;
  const int i1 = i0 + 8;
  float3 pa = make_float3(0.f, 0.f, 0.f), pb = pa;
  if (i0 < nt) pa = make_float3(tgt[3 * i0], tgt[3 * i0 + 1], tgt[3 * i0 + 2]);
  if (i1 < nt) pb = make_float3(tgt[3 * i1], tgt[3 * i1 + 1], tgt[3 * i1 + 2]);
  // Running totals over the tiles of columns 2 quad and 2 quad + 1 of rows
  // grp (oa) and grp + 8 (ob): quad 0 keeps (x, y), quad 1 z (its second
  // column, w, is not a total); quads 2 and 3 keep nothing.
  float oa0 = 0.f, oa1 = 0.f, ob0 = 0.f, ob1 = 0.f;
  for (int j0 = 0; j0 < ns; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    const float4 p = j < ns ? src[j] : zero4;
    const float3 c = tile_mean(make_float3(p.x, p.y, p.z), red, &mean);
    {
      const float x = p.x - c.x, y = p.y - c.y, z = p.z - c.z;
      q_tile[threadIdx.x] = make_float4(x, y, z, p.w);
      tj2_tile[threadIdx.x] = square3(x, y, z);
      const float v[4] = {x, y, z, 1.f};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const __nv_bfloat16 hi = __float2bfloat16_rn(v[n]);
        b_tile[n][threadIdx.x] = hi;
        b_tile[4 + n][threadIdx.x] = __float2bfloat16_rn(__fsub_rn(v[n], __bfloat162float(hi)));
      }
    }
    __syncthreads();

    Target ta, tb;
    ta.x = pa.x - c.x, ta.y = pa.y - c.y, ta.z = pa.z - c.z;
    tb.x = pb.x - c.x, tb.y = pb.y - c.y, tb.z = pb.z - c.z;
    ta.t2 = square3(ta.x, ta.y, ta.z);
    tb.t2 = square3(tb.x, tb.y, tb.z);
    float sum1[4] = {0.f, 0.f, 0.f, 0.f}, sum2[4] = {0.f, 0.f, 0.f, 0.f};  // S1, S2
#pragma unroll 2
    for (int k0 = 0; k0 < kTile; k0 += kChunk) {
      const int ka = k0 + 2 * quad, kb = ka + 8;  // this lane's sources ka, ka + 1, kb, kb + 1
      const float4 q0 = q_tile[ka], q1 = q_tile[ka + 1], q2 = q_tile[kb], q3 = q_tile[kb + 1];
      const float s0 = tj2_tile[ka], s1 = tj2_tile[ka + 1], s2 = tj2_tile[kb], s3 = tj2_tile[kb + 1];
      uint32_t h0, l0, h1, l1, h2, l2, h3, l3;
      split2(weight(ta, q0, s0, eps2), weight(ta, q1, s1, eps2), h0, l0);  // row grp, sources ka, ka + 1
      split2(weight(tb, q0, s0, eps2), weight(tb, q1, s1, eps2), h1, l1);  // row grp + 8
      split2(weight(ta, q2, s2, eps2), weight(ta, q3, s3, eps2), h2, l2);  // row grp, sources kb, kb + 1
      split2(weight(tb, q2, s2, eps2), weight(tb, q3, s3, eps2), h3, l3);  // row grp + 8
      // B: column grp, sources (rows) ka, ka + 1 and kb, kb + 1
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&b_tile[grp][ka]);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&b_tile[grp][kb]);
      float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(c1, h0, h1, h2, h3, b0, b1);
      mma_bf16(c2, l0, l1, l2, l3, b0, b1);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sum1[r] = __fadd_rn(sum1[r], c1[r]);
        sum2[r] = __fadd_rn(sum2[r], c2[r]);
      }
    }
    // tmp = (w_hi P_hi + w_hi P_lo) + w_lo P_hi; w_hi P_lo's columns of S1
    // sit two lanes to the right of w_hi P_hi's
    float tmp[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) tmp[r] = __fadd_rn(__fadd_rn(sum1[r], __shfl_down_sync(0xffffffffu, sum1[r], 2)), sum2[r]);
    // tmp_w of rows grp and grp + 8: column 3, in quad 1's second register
    const int w_lane = (lane & ~3) | 1;
    const float wa = __shfl_sync(0xffffffffu, tmp[1], w_lane);
    const float wb = __shfl_sync(0xffffffffu, tmp[3], w_lane);
    if (quad == 0) {
      oa0 = __fadd_rn(oa0, __fsub_rn(tmp[0], __fmul_rn(ta.x, wa)));
      oa1 = __fadd_rn(oa1, __fsub_rn(tmp[1], __fmul_rn(ta.y, wa)));
      ob0 = __fadd_rn(ob0, __fsub_rn(tmp[2], __fmul_rn(tb.x, wb)));
      ob1 = __fadd_rn(ob1, __fsub_rn(tmp[3], __fmul_rn(tb.y, wb)));
    } else if (quad == 1) {
      oa0 = __fadd_rn(oa0, __fsub_rn(tmp[0], __fmul_rn(ta.z, wa)));
      ob0 = __fadd_rn(ob0, __fsub_rn(tmp[2], __fmul_rn(tb.z, wb)));
    }
    __syncthreads();
  }
  if (quad == 0) {
    if (i0 < nt) {
      acc[3 * i0 + 0] = oa0 * g;
      acc[3 * i0 + 1] = oa1 * g;
    }
    if (i1 < nt) {
      acc[3 * i1 + 0] = ob0 * g;
      acc[3 * i1 + 1] = ob1 * g;
    }
  } else if (quad == 1) {
    if (i0 < nt) acc[3 * i0 + 2] = oa0 * g;
    if (i1 < nt) acc[3 * i1 + 2] = ob0 * g;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes: launches on `stream` and returns
// the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int nbx_pairwise_mxu(const void* tgt, const void* src, void* acc, int nt, int ns, float g, float eps2,
                                void* stream) {
  if (nt <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (nt + kRows - 1) / kRows;
  pairwise_mxu_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tgt), static_cast<const float4*>(src), static_cast<float*>(acc), nt, ns, g, eps2);
  return static_cast<int>(cudaGetLastError());
}
