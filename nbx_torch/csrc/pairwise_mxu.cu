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
// Design: a warp owns kM = 2 tiles of 16 targets (the MMA's M), whose MMAs
// share each chunk's shared loads and B fragments, 8 warps a block, so a
// block holds 256 targets; a second grid dimension splits the sources into
// runs of whole tiles (split_sum.cuh), so that the drift gate's 16,384
// targets (64 blocks) fill the card as 512, and every tile keeps its
// centroid. The sources come in tiles of 256, one a thread at the load,
// where the tile forms its centroid (warp 0: lane b < 8 sums block b,
// lane 0 then the blocks), its centred sources and |p_j - c|^2, and the B
// operand of
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 for every 16-source
// chunk: 8 columns [P_hi (4) | P_lo (4)], stored column by column, so that
// one MMA gives both w_hi P_hi and w_hi P_lo. For each chunk and M tile
// each lane computes the 8 weights that sit in its A fragment (targets l/4 and
// l/4 + 8, sources 2 (l%4) + {0, 1} and + 8) on the CUDA cores, rounding
// each product and sum where the plain version does (`__fmul_rn`,
// `__fadd_rn`, `__fmaf_rn`: no other contraction), splits them into bf16
// hi and lo, and issues two MMAs from zero: w_hi [P_hi | P_lo] into C1 and
// w_lo [P_hi | P_lo] into C2, whose columns 4-7 (w_lo P_lo, which the
// formulation drops) are never read. Each lane adds C1 and C2 to the
// tile's float32 sums S1 and S2, chunk after chunk. At the tile's end the
// lanes that hold columns 0-3 add S1's columns 4-7 from two lanes to the
// right, then S2, and un-centre into their split's running totals; the lane
// holding x and y of a row takes that row's tmp_w from the lane to its
// right. Each split writes its totals to part[s, i, 0:3]; `combine_splits`
// adds the splits in turn and multiplies by G. Source lanes past Ns load
// position 0 and mass 0, as the TPU kernel's padding lanes; target rows past
// Nt compute and store nothing.
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
// w - hi 1, the tile's sums 1), one rsqrt on the SFU (rsqrt.approx.ftz alone
// where eps^2 is normal, split_sum.cuh), two float32-to-bf16 conversions (w's
// hi and lo; an F2FP packs two values' hi, or their lo: chip_smoke.py counts
// conversions by value, at the rate bench/cvt_rate.py measures) and 1/128 of
// a warp's MMA, whose FLOPs are a few percent of the tensor cores' rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "mma_bf16.cuh"
#include "split_sum.cuh"

namespace {

using nbx_mma::mma_bf16;
using nbx_mma::split2;
using nbx_sum::cross3;
using nbx_sum::square3;

constexpr int kTile = nbx_sum::kTile;          // sources a tile, one a thread at the load
constexpr int kThreads = kTile;                // 8 warps
constexpr int kWarpRows = 16;                  // targets an M tile: the MMA's M
// M tiles a warp (ops/pairwise.py SPLIT_KERNELS): 2 over 1 measured 3.5%
// faster at 262,144 and 1-5% at 16,384 (PERF.md)
constexpr int kM = 2;
constexpr int kRows = kThreads / 32 * kM * kWarpRows;  // targets a block
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
template <bool kFtz>
__device__ __forceinline__ float weight(const Target& t, float4 q, float tj2, float eps2) {
  const float cross = cross3(t.x, t.y, t.z, q.x, q.y, q.z);
  const float r2 = fmaxf(__fadd_rn(__fsub_rn(__fadd_rn(t.t2, tj2), __fmul_rn(2.f, cross)), eps2), eps2);
  const float inv = nbx_sum::rsqrt_of<kFtz>(r2);
  return inv * inv * inv * q.w;
}

// Block (x, s): its kRows targets against split s of the sources, into
// part[s, i, 0:3].
template <bool kFtz>
__global__ void __launch_bounds__(kThreads)
pairwise_mxu_kernel(const float* __restrict__ tgt,   // [nt, 3]
                    const float4* __restrict__ src,  // [ns] (x, y, z, m)
                    float* __restrict__ part,        // [splits, nt, 3]
                    int nt, int ns, float eps2, int tiles_per_split) {
  __shared__ float4 q_tile[kTile];                         // (x - c, y - c, z - c, m)
  __shared__ float tj2_tile[kTile];                        // |p_j - c|^2
  __shared__ __align__(16) __nv_bfloat16 b_tile[kCols][kPitch];  // B by column: P_hi (x, y, z, 1), P_lo
  __shared__ float3 red[kTile / kBlock * kRedPitch], mean;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2, quad = lane & 3;  // the fragments' row group and column pair
  // this lane's targets in M tile m: rows grp and grp + 8 of the tile's 16
  int ia[kM], ib[kM];
  float3 pa[kM], pb[kM];
  // Running totals over the split's tiles of columns 2 quad and 2 quad + 1
  // of rows grp (oa) and grp + 8 (ob): quad 0 keeps (x, y), quad 1 z (its
  // second column, w, is not a total); quads 2 and 3 keep nothing.
  float oa0[kM], oa1[kM], ob0[kM], ob1[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    ia[m] = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kM * kWarpRows + m * kWarpRows + grp;
    ib[m] = ia[m] + 8;
    pa[m] = pb[m] = make_float3(0.f, 0.f, 0.f);
    if (ia[m] < nt) pa[m] = make_float3(tgt[3 * ia[m]], tgt[3 * ia[m] + 1], tgt[3 * ia[m] + 2]);
    if (ib[m] < nt) pb[m] = make_float3(tgt[3 * ib[m]], tgt[3 * ib[m] + 1], tgt[3 * ib[m] + 2]);
    oa0[m] = oa1[m] = ob0[m] = ob1[m] = 0.f;
  }
  const int2 range = nbx_sum::split_range(ns, tiles_per_split);
  for (int j0 = range.x; j0 < range.y; j0 += kTile) {
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

    Target ta[kM], tb[kM];
    float sum1[kM][4], sum2[kM][4];  // S1, S2
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      ta[m].x = pa[m].x - c.x, ta[m].y = pa[m].y - c.y, ta[m].z = pa[m].z - c.z;
      tb[m].x = pb[m].x - c.x, tb[m].y = pb[m].y - c.y, tb[m].z = pb[m].z - c.z;
      ta[m].t2 = square3(ta[m].x, ta[m].y, ta[m].z);
      tb[m].t2 = square3(tb[m].x, tb[m].y, tb[m].z);
#pragma unroll
      for (int r = 0; r < 4; ++r) sum1[m][r] = sum2[m][r] = 0.f;
    }
#pragma unroll 2
    for (int k0 = 0; k0 < kTile; k0 += kChunk) {
      const int ka = k0 + 2 * quad, kb = ka + 8;  // this lane's sources ka, ka + 1, kb, kb + 1
      const float4 q0 = q_tile[ka], q1 = q_tile[ka + 1], q2 = q_tile[kb], q3 = q_tile[kb + 1];
      const float s0 = tj2_tile[ka], s1 = tj2_tile[ka + 1], s2 = tj2_tile[kb], s3 = tj2_tile[kb + 1];
      // B: column grp, sources (rows) ka, ka + 1 and kb, kb + 1
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&b_tile[grp][ka]);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&b_tile[grp][kb]);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        uint32_t h0, l0, h1, l1, h2, l2, h3, l3;
        split2(weight<kFtz>(ta[m], q0, s0, eps2), weight<kFtz>(ta[m], q1, s1, eps2), h0, l0);  // row grp, ka, ka + 1
        split2(weight<kFtz>(tb[m], q0, s0, eps2), weight<kFtz>(tb[m], q1, s1, eps2), h1, l1);  // row grp + 8
        split2(weight<kFtz>(ta[m], q2, s2, eps2), weight<kFtz>(ta[m], q3, s3, eps2), h2, l2);  // row grp, kb, kb + 1
        split2(weight<kFtz>(tb[m], q2, s2, eps2), weight<kFtz>(tb[m], q3, s3, eps2), h3, l3);  // row grp + 8
        float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(c1, h0, h1, h2, h3, b0, b1);
        mma_bf16(c2, l0, l1, l2, l3, b0, b1);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          sum1[m][r] = __fadd_rn(sum1[m][r], c1[r]);
          sum2[m][r] = __fadd_rn(sum2[m][r], c2[r]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      // tmp = (w_hi P_hi + w_hi P_lo) + w_lo P_hi; w_hi P_lo's columns of S1
      // sit two lanes to the right of w_hi P_hi's
      float tmp[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        tmp[r] = __fadd_rn(__fadd_rn(sum1[m][r], __shfl_down_sync(0xffffffffu, sum1[m][r], 2)), sum2[m][r]);
      }
      // tmp_w of rows grp and grp + 8: column 3, in quad 1's second register
      const int w_lane = (lane & ~3) | 1;
      const float wa = __shfl_sync(0xffffffffu, tmp[1], w_lane);
      const float wb = __shfl_sync(0xffffffffu, tmp[3], w_lane);
      if (quad == 0) {
        oa0[m] = __fadd_rn(oa0[m], __fsub_rn(tmp[0], __fmul_rn(ta[m].x, wa)));
        oa1[m] = __fadd_rn(oa1[m], __fsub_rn(tmp[1], __fmul_rn(ta[m].y, wa)));
        ob0[m] = __fadd_rn(ob0[m], __fsub_rn(tmp[2], __fmul_rn(tb[m].x, wb)));
        ob1[m] = __fadd_rn(ob1[m], __fsub_rn(tmp[3], __fmul_rn(tb[m].y, wb)));
      } else if (quad == 1) {
        oa0[m] = __fadd_rn(oa0[m], __fsub_rn(tmp[0], __fmul_rn(ta[m].z, wa)));
        ob0[m] = __fadd_rn(ob0[m], __fsub_rn(tmp[2], __fmul_rn(tb[m].z, wb)));
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.y) * nt * 3;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    if (quad == 0) {
      if (ia[m] < nt) {
        out[3 * ia[m] + 0] = oa0[m];
        out[3 * ia[m] + 1] = oa1[m];
      }
      if (ib[m] < nt) {
        out[3 * ib[m] + 0] = ob0[m];
        out[3 * ib[m] + 1] = ob1[m];
      }
    } else if (quad == 1) {
      if (ia[m] < nt) out[3 * ia[m] + 2] = oa0[m];
      if (ib[m] < nt) out[3 * ib[m] + 2] = ob0[m];
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes: `part` is [splits, nt, 3] float32
// scratch, splits = ceil(ceil(ns / 256) / tiles_per_split) (at least 1).
// Launches the split sum and the combine on `stream` and returns the
// launches' cudaError_t (0 on success); does not synchronise. MUFU.RSQ
// alone where eps^2 is a normal float32, rsqrtf below.
extern "C" int nbx_pairwise_mxu(const void* tgt, const void* src, void* part, void* acc, int nt, int ns, float g,
                                float eps2, int tiles_per_split, void* stream) {
  return nbx_sum::launch3(eps2 >= FLT_MIN ? pairwise_mxu_kernel<true> : pairwise_mxu_kernel<false>, kRows, tgt, src,
                          part, acc, nt, ns, g, eps2, tiles_per_split, stream);
}
