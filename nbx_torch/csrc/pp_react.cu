// K5: the P3M residual-versus-table pass, both directions, float32, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_pp_react_kernel` of nbx/ops/ppkernel.py:143, as
// launched by `residual_table_acc_pallas` (:681): each live residual against
// the kept bodies of every affected cell (the 27-dilation of the overflowing
// cells), giving the residual its force G sum_j wbase m_j d and each kept
// body the reaction -G sum_t wbase m_t d, d = p_kept - p_res, masked r^2 > 0
// and, on the forward side, m_j > 0.
//
// Design: one law evaluation a pair feeds both sums, as the TPU kernel's row
// and column sums of one `wbase` block do. The wrapper
// (nbx_torch/ops/ppkernel.py) gathers the affected cells' kept runs into one
// array of rows, a live prefix and then parked rows (mass 0, output row -1),
// kRows rows a block. Block (b, r) holds kept rows b kRows ... in registers,
// kKept a thread, with their reactions, and streams run r of the live
// residuals (runs of whole tiles, kSplits of them) through shared memory,
// kResTile at a time. The runs give the grid many times the blocks the card
// holds at once: the 1M merger's 490 live blocks of kept rows alone fill
// less than one uneven wave. 8 kept rows a thread and 16 runs ran faster
// than 2 or 4 rows and 1 to 12 runs (PERF.md).
//
// The forward sum of a residual spans the block's kKept x threads kept
// bodies, so it is reduced across threads, in a fixed order and without
// atomics:
//   within a warp, by rotation: the residuals go in chunks of 32; at step s
//   lane l meets residual (l + s) mod 32 and adds to that residual's running
//   sum, which it then passes to lane l - 1 (one SHFL a component, 3 a step
//   for kKept pairs). After 32 steps each residual's sum has visited every
//   lane, in a fixed order, and rests on the lane of its own index. The
//   chunk is stored twice in a row in shared memory, so lane l's read at
//   step s is row l + s, an immediate offset;
//   across the warps, in warp order through shared memory, once a tile, to
//   the block's partial part[b, t, :];
//   across the blocks, in a second launch (pp_react_combine): the live
//   blocks' partials added in block order, times G, to the residual's
//   output row.
// The reactions go to react[r, j, :], and the combine adds a kept row's runs
// in run order, times -G, to its output row. Residual rows and kept rows are
// distinct bodies, so every row of `out` has one writer, and the same inputs
// give the same bits.
//
// The live counts (residuals, kept rows) come from device memory: the host
// sizes the grid from the caps alone, and a block with no live kept row
// exits at once, as does every thread of the combine past the live rows.
//
// Bound: FP32 and SFU issue. A pair issues 3 differences, r^2 (3), the law
// of pp_law.cuh (pair_base_approx: about 19 with its 3 MUFU), the two
// weights (2) and the two sums (6); per pair 3 / kKept SHFL and 1 / kKept
// shared loads for the rotation, and nothing from device memory.

#include <cfloat>
#include <cuda_runtime.h>

#include "pp_law.cuh"

namespace {

constexpr int kRows = 1024;   // kept rows a block (ops/ppkernel.py REACT_ROWS)
constexpr int kKept = 8;      // kept rows a thread
constexpr int kThreads = kRows / kKept;
constexpr int kWarps = kThreads / 32;
constexpr int kSplits = 16;   // runs of the live residuals (ops/ppkernel.py REACT_SPLITS)
constexpr int kChunk = 32;    // residuals a warp's rotation
constexpr int kResTile = 256;  // residuals a tile in shared memory

template <bool kFtz>
__global__ void __launch_bounds__(kThreads)
pp_react_kernel(const float4* __restrict__ res,    // [m] (x, y, z, m), live prefix
                const float4* __restrict__ kept,   // [n_rows] (x, y, z, m), live prefix
                const int* __restrict__ counts,    // [2] live residuals, live kept rows
                float* __restrict__ part,          // [n_rows / kRows, m, 3]
                float* __restrict__ react,         // [kSplits, n_rows, 3]
                int m, int n_rows, nbx_pp::Law law) {
  __shared__ float4 tile[2 * kResTile];             // each chunk of 32 twice in a row
  __shared__ float fwd[3][kWarps][kResTile];        // the warps' sums of a tile's residuals
  const int row0 = blockIdx.x * kRows;
  if (row0 >= counts[1]) return;  // no live kept row: the whole block
  // this block's run of the live residuals: whole tiles
  const int n_res = counts[0];
  const int per = ((n_res + kResTile - 1) / kResTile + kSplits - 1) / kSplits * kResTile;
  const int lo = min(n_res, static_cast<int>(blockIdx.y) * per);
  const int hi = min(n_res, lo + per);
  const nbx_pp::LawApprox la = nbx_pp::approx_of(law);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int next = (lane + 1) & 31;

  float kx[kKept], ky[kKept], kz[kKept], km[kKept];  // kept body kk: row row0 + kk kThreads + thread
  float rx[kKept], ry[kKept], rz[kKept];             // its reaction, before -G
#pragma unroll
  for (int kk = 0; kk < kKept; ++kk) {
    const float4 q = kept[row0 + kk * kThreads + threadIdx.x];
    kx[kk] = q.x;
    ky[kk] = q.y;
    kz[kk] = q.z;
    km[kk] = q.w > 0.f ? q.w : 0.f;  // the forward side's m_j > 0 mask
    rx[kk] = ry[kk] = rz[kk] = 0.f;
  }

  for (int t0 = lo; t0 < hi; t0 += kResTile) {
    const int nt = min(kResTile, hi - t0);
    __syncthreads();  // the previous tile's rows and sums are read
    for (int l = threadIdx.x; l < kResTile; l += kThreads) {
      const float4 q = l < nt ? res[t0 + l] : make_float4(0.f, 0.f, 0.f, 0.f);
      tile[2 * (l & ~(kChunk - 1)) + (l & (kChunk - 1))] = q;
      tile[2 * (l & ~(kChunk - 1)) + kChunk + (l & (kChunk - 1))] = q;
    }
    __syncthreads();
    const int chunks = (nt + kChunk - 1) / kChunk;
    for (int c = 0; c < chunks; ++c) {
      const float4* row = tile + 2 * kChunk * c + lane;
      float fx = 0.f, fy = 0.f, fz = 0.f;  // the running sum of residual (lane + s) mod 32
#pragma unroll 4
      for (int s = 0; s < kChunk; ++s) {
        const float4 q = row[s];
#pragma unroll
        for (int kk = 0; kk < kKept; ++kk) {
          const float dx = kx[kk] - q.x;
          const float dy = ky[kk] - q.y;
          const float dz = kz[kk] - q.z;
          const float r2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
          const float wb = nbx_pp::pair_base_approx<kFtz>(r2, la);
          const float wf = wb * km[kk];
          const float wr = wb * q.w;
          fx = __fmaf_rn(wf, dx, fx);
          fy = __fmaf_rn(wf, dy, fy);
          fz = __fmaf_rn(wf, dz, fz);
          rx[kk] = __fmaf_rn(wr, dx, rx[kk]);
          ry[kk] = __fmaf_rn(wr, dy, ry[kk]);
          rz[kk] = __fmaf_rn(wr, dz, rz[kk]);
        }
        fx = __shfl_sync(0xffffffffu, fx, next);
        fy = __shfl_sync(0xffffffffu, fy, next);
        fz = __shfl_sync(0xffffffffu, fz, next);
      }
      fwd[0][warp][kChunk * c + lane] = fx;  // residual kChunk c + lane, this warp's bodies
      fwd[1][warp][kChunk * c + lane] = fy;
      fwd[2][warp][kChunk * c + lane] = fz;
    }
    __syncthreads();
    for (int l = threadIdx.x; l < nt; l += kThreads) {
      float sx = fwd[0][0][l], sy = fwd[1][0][l], sz = fwd[2][0][l];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        sx = __fadd_rn(sx, fwd[0][w][l]);
        sy = __fadd_rn(sy, fwd[1][w][l]);
        sz = __fadd_rn(sz, fwd[2][w][l]);
      }
      float* p = part + (static_cast<size_t>(blockIdx.x) * m + t0 + l) * 3;
      p[0] = sx;
      p[1] = sy;
      p[2] = sz;
    }
  }

#pragma unroll
  for (int kk = 0; kk < kKept; ++kk) {
    float* r = react + (static_cast<size_t>(blockIdx.y) * n_rows + row0 + kk * kThreads + threadIdx.x) * 3;
    r[0] = rx[kk];
    r[1] = ry[kk];
    r[2] = rz[kk];
  }
}

// Thread t < m: residual t's force, the live blocks' partials in block
// order, times G, to its output row. Thread m + j: kept row j's reaction, the
// runs' partials in run order, times -G, to its output row.
__global__ void pp_react_combine(const float* __restrict__ part, const float* __restrict__ react,
                                 const int* __restrict__ res_out, const int* __restrict__ kept_out,
                                 const int* __restrict__ counts, float* __restrict__ out, int m, int n_rows,
                                 float g) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m) {
    const int j = t - m;
    if (j >= counts[1]) return;
    const float* p = react + static_cast<size_t>(j) * 3;
    float sx = p[0], sy = p[1], sz = p[2];
    for (int r = 1; r < kSplits; ++r) {
      const float* q = p + static_cast<size_t>(r) * n_rows * 3;
      sx = __fadd_rn(sx, q[0]);
      sy = __fadd_rn(sy, q[1]);
      sz = __fadd_rn(sz, q[2]);
    }
    float* o = out + static_cast<size_t>(kept_out[j]) * 3;
    o[0] = -g * sx;
    o[1] = -g * sy;
    o[2] = -g * sz;
    return;
  }
  const int blocks = (counts[1] + kRows - 1) / kRows;
  if (t >= counts[0] || blocks == 0) return;
  const float* p = part + static_cast<size_t>(t) * 3;
  float sx = p[0], sy = p[1], sz = p[2];
  for (int b = 1; b < blocks; ++b) {
    const float* q = p + static_cast<size_t>(b) * m * 3;
    sx = __fadd_rn(sx, q[0]);
    sy = __fadd_rn(sy, q[1]);
    sz = __fadd_rn(sz, q[2]);
  }
  const int o = res_out[t];
  if (o >= 0) {
    float* r = out + static_cast<size_t>(o) * 3;
    r[0] = g * sx;
    r[1] = g * sy;
    r[2] = g * sz;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. res [m] and res_out [m]: the
// residual rows and their output rows; kept [n_rows] and kept_out [n_rows]:
// the kept rows, n_rows a multiple of 1,024; counts [2] i32 on the card: the
// live residuals and kept rows (each a prefix); float32 scratch part
// [n_rows / 1,024, m, 3] (the forward partials) and react [16, n_rows, 3]
// (the reactions of each run of the residuals); out [n_out, 3], zeroed by
// the caller. Launches the pair kernel and the combine on `stream` and
// returns the launches' cudaError_t (0 on success); it does not
// synchronise.
extern "C" int nbx_pp_react(const void* res, const void* res_out, const void* kept, const void* kept_out,
                            const void* counts, void* part, void* react, void* out, int m, int n_rows, float eps2,
                            float inv_a, float c_a, float g, void* stream) {
  if (m < 0 || n_rows < 0 || n_rows % kRows) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n_rows == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  const nbx_pp::Law law{eps2, inv_a, c_a, g};
  const auto kernel = eps2 >= FLT_MIN ? pp_react_kernel<true> : pp_react_kernel<false>;
  auto* p = static_cast<float*>(part);
  auto* q = static_cast<float*>(react);
  const auto* n = static_cast<const int*>(counts);
  kernel<<<dim3(n_rows / kRows, kSplits), kThreads, 0, st>>>(static_cast<const float4*>(res),
                                                              static_cast<const float4*>(kept), n, p, q, m, n_rows,
                                                              law);
  constexpr int kCombine = 256;
  pp_react_combine<<<(m + n_rows + kCombine - 1) / kCombine, kCombine, 0, st>>>(
      p, q, static_cast<const int*>(res_out), static_cast<const int*>(kept_out), n, static_cast<float*>(out), m,
      n_rows, g);
  return static_cast<int>(cudaGetLastError());
}
