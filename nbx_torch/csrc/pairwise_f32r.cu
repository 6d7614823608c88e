// Softened direct-sum gravity, float32, for NVIDIA Hopper (sm_90a).
//
//   acc_i = G * sum_j m_j d_ij (|d_ij|^2 + eps^2)^(-3/2),   d_ij = p_j - p_i
//
// Replaces the TPU kernel `_f32r_acc_kernel` of nbx/ops/pairwise.py (behind
// `pairwise_acc`, precision "f32r"). It keeps that kernel's contract, not its
// blocks: Nt targets against Ns sources (Nt != Ns allowed), no diagonal mask
// (the self pair contributes w * 0 = 0, which needs eps > 0), mass-0 sources
// inert, float32 sums, G applied once at the end.
//
// Design: 256 threads a block, each with kTargets = 4 targets in registers
// (target t of thread l in block x: row x kThreads kTargets + t kThreads +
// l), so that a source's float4 (x, y, z, m) is read from shared memory once
// for 4 targets; and a second grid dimension over the sources
// (split_sum.cuh), so that small N still fills the card: at the drift gate's
// 16,384 bodies, 16 target blocks x 32 splits of 2 tiles = 512 blocks (64
// with one thread a target). The block walks its split's sources in tiles of
// 256 float4, loaded cooperatively into shared memory; each thread sums one
// tile into a partial per target and adds the partial to its running total,
// a two-level sum that keeps the float32 rounding of a 262,144-term sum near
// that of a 1,024-term one. The split's totals go to part[s, i, 0:3];
// `combine_splits` adds the splits in order and multiplies by G, without
// atomics, so the same inputs give the same bits. The kernel masks the
// ragged edges itself: source lanes past Ns load mass 0, target rows past Nt
// sum from the origin and store nothing.
//
// Bound: once a tile is in shared memory a pair costs 0 bytes of device
// memory traffic and FP32 and SFU issue bound the kernel. A pair issues 3
// differences, r^2 + eps^2 as three FMAs (fma(dz, dz, fma(dy, dy, fma(dx,
// dx, eps^2)))), one MUFU.RSQ, 3 FMULs for m / r^3 and 3 FMAs for the sums,
// and 1 / kTargets shared loads. rsqrt.approx.ftz alone replaces rsqrtf
// (and its guard for subnormal arguments) where eps^2 is normal
// (split_sum.cuh).
//
// The symmetric sum (pairwise_f32r_kernel_sym, entry nbx_pairwise_f32r_sym):
// where the targets are the sources, Newton's third law halves the work. The
// TPU kernel `_f32r_acc_kernel` is one-sided (every ordered pair, N^2 law
// evaluations); this kernel evaluates each unordered pair once and adds it
// to both bodies, K5's pattern (pp_react.cu) on the gravity law:
//   rows: the bodies in row tiles of kBlock = 1,024, T = ceil(N / kBlock)
//   tiles. Block (a, r) holds row tile a in registers, kRows rows a thread
//   (row a kBlock + k kSymThreads + thread), with their running sums;
//   work: tile a's units, a unit a source tile of kTile = 256 (kUnits = 4 a
//   row tile), in order: first the diagonal, tile a's own rows, one-sided
//   (every ordered pair, no reaction: 13 instructions a pair), then the
//   column tiles c = (a + d) mod T, d = 1 ... h(a), symmetric. h(a) = T / 2
//   (integer division) but for even T and a >= T / 2, where it is T / 2 - 1,
//   so every unordered pair of row tiles meets once and blocks differ by at
//   most one column tile. Block (a, r) takes run r of its U(a) units, units
//   [r U(a) / R, (r + 1) U(a) / R) of R runs, so that blocks differ by at
//   most one unit (ops/pairwise.py `symmetric_plan`: about 16,384 blocks,
//   64 runs at 262,144, so that the blocks' ends spread over many waves:
//   23.09 ms there against 25.4 at 512 blocks);
//   the pair: 3 differences, r^2 + eps^2 (3 FMAs), one MUFU.RSQ, r^-3 (2
//   FMULs), the weights m_j r^-3 and m_i r^-3 (2 FMULs), the row's sum and
//   the source's reaction (6 FMAs): 17 instructions an unordered pair,
//   against the one-sided kernel's 2 x 13.5625;
//   reactions, within a warp by rotation: a source tile goes in chunks of 32,
//   each stored twice in a row in shared memory, so lane l's read at step s
//   is row l + s, an immediate offset; at step s lane l meets source (l + s)
//   mod 32, adds its kRows pairs to that source's running reaction and
//   passes it to lane l - 1 (3 SHFL a step for kRows pairs); after 32 steps
//   source l's reaction rests on lane l. Across the warps, in warp order
//   through shared memory, once a unit, to the column slot (a, d);
//   rows: each unit's sum is added to the row's running sum (two levels, as
//   in the one-sided kernel); run r's totals go to rows[r, i, :].
// Partials and the combine: rows [runs, N, 3] (0.20 GB at 262,144); cols [T
// H, kBlock, 3], H = T / 2, slot (a, d) at a H + d - 1 holding tile (a + d)
// mod T's reactions from row tile a: N^2 / (2 kBlock) x 12 bytes, 0.40 GB at
// 262,144 (0.5% of an H100's 80 GB). combine_splits_sym adds body i's row
// partials in run order, then subtracts its reactions from the writers a =
// c - d, d = 1 ... H, in that order (c = i's tile), and multiplies by G.
// Every slot it reads is written by exactly one block, so the scratch comes
// from torch.empty, and nothing uses atomics: the same inputs give the same
// bits.
// Bound: issue, as the one-sided kernel's: 17 instructions, 3 / kRows SHFL
// and 1 / kRows shared loads an unordered pair, plus the loop (unrolled 8
// steps: a full unroll of 32 overflows the instruction cache), against 128
// instructions a clock an SM: 17.70 in its SASS. The main kernel writes the
// partials under its compute; the combine reads them (0.17 ms at 262,144).

#include <cfloat>
#include <cuda_runtime.h>

#include "split_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = nbx_sum::kTile;
constexpr int kTargets = 4;  // ops/pairwise.py TARGETS
static_assert(kTile == kThreads, "one source a thread at the tile's load");

template <bool kFtz>
__global__ void __launch_bounds__(kThreads)
pairwise_f32r_kernel(const float* __restrict__ tgt,   // [nt, 3]
                     const float4* __restrict__ src,  // [ns] (x, y, z, m)
                     float* __restrict__ part,        // [splits, nt, 3]
                     int nt, int ns, float eps2, int tiles_per_split) {
  __shared__ float4 tile[kTile];
  const int i0 = blockIdx.x * kThreads * kTargets + threadIdx.x;
  float xi[kTargets], yi[kTargets], zi[kTargets];
  float ax[kTargets], ay[kTargets], az[kTargets];  // the split's totals, before G
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = i0 + t * kThreads;
    xi[t] = i < nt ? tgt[3 * i + 0] : 0.f;
    yi[t] = i < nt ? tgt[3 * i + 1] : 0.f;
    zi[t] = i < nt ? tgt[3 * i + 2] : 0.f;
    ax[t] = ay[t] = az[t] = 0.f;
  }
  const int2 range = nbx_sum::split_range(ns, tiles_per_split);
  for (int j0 = range.x; j0 < range.y; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    tile[threadIdx.x] = j < ns ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    float tx[kTargets], ty[kTargets], tz[kTargets];
#pragma unroll
    for (int t = 0; t < kTargets; ++t) tx[t] = ty[t] = tz[t] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      const float4 s = tile[k];
#pragma unroll
      for (int t = 0; t < kTargets; ++t) {
        const float dx = s.x - xi[t];
        const float dy = s.y - yi[t];
        const float dz = s.z - zi[t];
        const float r2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, eps2)));
        const float inv = nbx_sum::rsqrt_of<kFtz>(r2);
        const float w = inv * inv * inv * s.w;  // f * m_j
        tx[t] = __fmaf_rn(w, dx, tx[t]);
        ty[t] = __fmaf_rn(w, dy, ty[t]);
        tz[t] = __fmaf_rn(w, dz, tz[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kTargets; ++t) {
      ax[t] += tx[t];
      ay[t] += ty[t];
      az[t] += tz[t];
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.y) * nt * 3;
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int i = i0 + t * kThreads;
    if (i < nt) {
      out[3 * i + 0] = ax[t];
      out[3 * i + 1] = ay[t];
      out[3 * i + 2] = az[t];
    }
  }
}

constexpr int kBlock = 1024;                 // rows a block (ops/pairwise.py SYM_ROWS)
constexpr int kRows = 8;                     // rows a thread
constexpr int kSymThreads = kBlock / kRows;
constexpr int kSymWarps = kSymThreads / 32;
constexpr int kUnits = kBlock / kTile;       // source tiles (units) a row tile
constexpr int kChunk = 32;                   // sources a warp's rotation

// Column tiles of row tile a beyond its diagonal, h(a), for T tiles.
__device__ __forceinline__ int half_ring(int a, int tiles) {
  const int h = tiles / 2;
  return (tiles % 2 == 0 && a >= h) ? h - 1 : h;
}

template <bool kFtz>
__global__ void __launch_bounds__(kSymThreads)
pairwise_f32r_kernel_sym(const float4* __restrict__ src,  // [n] (x, y, z, m)
                         float* __restrict__ rows,        // [runs, n, 3]
                         float* __restrict__ cols,        // [T H, kBlock, 3]
                         int n, float eps2) {
  __shared__ float4 tile[2 * kTile];            // each chunk of 32 twice in a row
  __shared__ float react[3][kSymWarps][kTile];  // the warps' reactions of a unit's sources
  const int tiles = (n + kBlock - 1) / kBlock;
  const int half = tiles / 2;
  const int a = blockIdx.x;
  const int units = kUnits * (1 + half_ring(a, tiles));
  const int u0 = static_cast<int>(blockIdx.y) * units / static_cast<int>(gridDim.y);
  const int u1 = static_cast<int>(blockIdx.y + 1) * units / static_cast<int>(gridDim.y);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int next = (lane + 1) & 31;

  float xi[kRows], yi[kRows], zi[kRows], mi[kRows];
  float ax[kRows], ay[kRows], az[kRows];  // the run's totals, before G
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = a * kBlock + k * kSymThreads + threadIdx.x;
    const float4 q = i < n ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    xi[k] = q.x;
    yi[k] = q.y;
    zi[k] = q.z;
    mi[k] = q.w;
    ax[k] = ay[k] = az[k] = 0.f;
  }

  for (int u = u0; u < u1; ++u) {
    const int d = u / kUnits;
    const int c = a + d < tiles ? a + d : a + d - tiles;
    const int j0 = c * kBlock + (u % kUnits) * kTile;
    if (j0 >= n) continue;  // a unit past the last body: the whole block
    __syncthreads();        // the previous unit's sources and reactions are read
    for (int l = threadIdx.x; l < kTile; l += kSymThreads) {
      const float4 q = j0 + l < n ? src[j0 + l] : make_float4(0.f, 0.f, 0.f, 0.f);
      tile[2 * (l & ~(kChunk - 1)) + (l & (kChunk - 1))] = q;
      tile[2 * (l & ~(kChunk - 1)) + kChunk + (l & (kChunk - 1))] = q;
    }
    __syncthreads();
    float tx[kRows], ty[kRows], tz[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) tx[k] = ty[k] = tz[k] = 0.f;
    if (d == 0) {  // the diagonal: the block's own rows, one-sided
      for (int ch = 0; ch < kTile / kChunk; ++ch) {
        const float4* row = tile + 2 * kChunk * ch;
#pragma unroll 2
        for (int s = 0; s < kChunk; ++s) {
          const float4 q = row[s];
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const float dx = q.x - xi[k];
            const float dy = q.y - yi[k];
            const float dz = q.z - zi[k];
            const float r2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, eps2)));
            const float inv = nbx_sum::rsqrt_of<kFtz>(r2);
            const float w = inv * inv * inv * q.w;
            tx[k] = __fmaf_rn(w, dx, tx[k]);
            ty[k] = __fmaf_rn(w, dy, ty[k]);
            tz[k] = __fmaf_rn(w, dz, tz[k]);
          }
        }
      }
    } else {
      for (int ch = 0; ch < kTile / kChunk; ++ch) {
        const float4* row = tile + 2 * kChunk * ch + lane;
        float fx = 0.f, fy = 0.f, fz = 0.f;  // the reaction of source (lane + s) mod 32, before -G
#pragma unroll 8
        for (int s = 0; s < kChunk; ++s) {
          const float4 q = row[s];
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const float dx = q.x - xi[k];
            const float dy = q.y - yi[k];
            const float dz = q.z - zi[k];
            const float r2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, eps2)));
            const float inv = nbx_sum::rsqrt_of<kFtz>(r2);
            const float w = inv * inv * inv;
            const float wj = w * q.w;
            const float wi = w * mi[k];
            tx[k] = __fmaf_rn(wj, dx, tx[k]);
            ty[k] = __fmaf_rn(wj, dy, ty[k]);
            tz[k] = __fmaf_rn(wj, dz, tz[k]);
            fx = __fmaf_rn(wi, dx, fx);
            fy = __fmaf_rn(wi, dy, fy);
            fz = __fmaf_rn(wi, dz, fz);
          }
          fx = __shfl_sync(0xffffffffu, fx, next);
          fy = __shfl_sync(0xffffffffu, fy, next);
          fz = __shfl_sync(0xffffffffu, fz, next);
        }
        react[0][warp][kChunk * ch + lane] = fx;
        react[1][warp][kChunk * ch + lane] = fy;
        react[2][warp][kChunk * ch + lane] = fz;
      }
      __syncthreads();
      float* slot = cols + ((static_cast<size_t>(a) * half + d - 1) * kBlock + (u % kUnits) * kTile) * 3;
      for (int l = threadIdx.x; l < kTile && j0 + l < n; l += kSymThreads) {
        float sx = react[0][0][l], sy = react[1][0][l], sz = react[2][0][l];
#pragma unroll
        for (int w = 1; w < kSymWarps; ++w) {
          sx = __fadd_rn(sx, react[0][w][l]);
          sy = __fadd_rn(sy, react[1][w][l]);
          sz = __fadd_rn(sz, react[2][w][l]);
        }
        slot[3 * l + 0] = sx;
        slot[3 * l + 1] = sy;
        slot[3 * l + 2] = sz;
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      ax[k] += tx[k];
      ay[k] += ty[k];
      az[k] += tz[k];
    }
  }
  float* out = rows + static_cast<size_t>(blockIdx.y) * n * 3;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = a * kBlock + k * kSymThreads + threadIdx.x;
    if (i < n) {
      out[3 * i + 0] = ax[k];
      out[3 * i + 1] = ay[k];
      out[3 * i + 2] = az[k];
    }
  }
}

// acc_i = G (rows[0, i] + ... + rows[runs - 1, i] - cols[c - 1 mod T, 1, i]
// - cols[c - 2 mod T, 2, i] - ...), c = i's row tile: the row partials in run
// order, then the reactions of the writers a = c - d, d = 1 ... H, that reach
// tile c (d <= h(a)).
__global__ void combine_splits_sym(const float* __restrict__ rows, const float* __restrict__ cols,
                                   float* __restrict__ acc, int n, int runs, float g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float ox = rows[3 * i + 0], oy = rows[3 * i + 1], oz = rows[3 * i + 2];
  for (int r = 1; r < runs; ++r) {
    const float* p = rows + (static_cast<size_t>(r) * n + i) * 3;
    ox = __fadd_rn(ox, p[0]);
    oy = __fadd_rn(oy, p[1]);
    oz = __fadd_rn(oz, p[2]);
  }
  const int tiles = (n + kBlock - 1) / kBlock;
  const int half = tiles / 2;
  const int c = i / kBlock;
  for (int d = 1; d <= half; ++d) {
    const int a = c >= d ? c - d : c - d + tiles;
    if (d > half_ring(a, tiles)) continue;
    const float* p = cols + ((static_cast<size_t>(a) * half + d - 1) * kBlock + i % kBlock) * 3;
    ox = __fsub_rn(ox, p[0]);
    oy = __fsub_rn(oy, p[1]);
    oz = __fsub_rn(oz, p[2]);
  }
  acc[3 * i + 0] = ox * g;
  acc[3 * i + 1] = oy * g;
  acc[3 * i + 2] = oz * g;
}

}  // namespace

// Plain C entry point, loaded with ctypes. `part` is [splits, nt, 3] float32
// scratch, splits = ceil(ceil(ns / 256) / tiles_per_split) (at least 1).
// Launches the split sum and the combine on `stream` and returns the
// launches' cudaError_t (0 on success); it does not synchronise. MUFU.RSQ
// alone where eps^2 is a normal float32, rsqrtf below.
extern "C" int nbx_pairwise_f32r(const void* tgt, const void* src, void* part, void* acc, int nt, int ns, float g,
                                 float eps2, int tiles_per_split, void* stream) {
  return nbx_sum::launch3(eps2 >= FLT_MIN ? pairwise_f32r_kernel<true> : pairwise_f32r_kernel<false>,
                          kThreads * kTargets, tgt, src, part, acc, nt, ns, g, eps2, tiles_per_split, stream);
}

// The symmetric sum, loaded with ctypes: src [n] float4 (x, y, z, m), the
// targets being the sources; float32 scratch rows [runs, n, 3] and cols [T H,
// 1,024, 3] (T = ceil(n / 1,024), H = T / 2), every slot that the combine
// reads written by the main kernel; acc [n, 3]; runs >= 1. Launches the main
// kernel over T x runs blocks and the
// combine on `stream` and returns the launches' cudaError_t (0 on success);
// it does not synchronise.
extern "C" int nbx_pairwise_f32r_sym(const void* src, void* rows, void* cols, void* acc, int n, float g, float eps2,
                                     int runs, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (runs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kBlock - 1) / kBlock;
  auto* r = static_cast<float*>(rows);
  auto* c = static_cast<float*>(cols);
  const auto kernel = eps2 >= FLT_MIN ? pairwise_f32r_kernel_sym<true> : pairwise_f32r_kernel_sym<false>;
  kernel<<<dim3(tiles, runs), kSymThreads, 0, st>>>(static_cast<const float4*>(src), r, c, n, eps2);
  constexpr int kCombine = 256;
  combine_splits_sym<<<(n + kCombine - 1) / kCombine, kCombine, 0, st>>>(r, c, static_cast<float*>(acc), n, runs, g);
  return static_cast<int>(cudaGetLastError());
}
