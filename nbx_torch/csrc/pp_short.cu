// K4: the P3M short-range pair pass, float32, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_pp_kernel` of nbx/ops/ppkernel.py:59, as launched
// by `short_range_acc_pallas` (:259, the main pass, uniform or
// occupancy-bucketed cells) and `residual_rr_dense_pallas` (:600, the dense
// residual-residual block). It keeps that kernel's contract, not its blocks:
// each kept target against the kept bodies of its 27 neighbour cells, or each
// live residual against every live residual, with the law and masks of
// pp_law.cuh (r^2 > 0 and m_j > 0).
//
// A pass is a list of work items, one a block. Item w is one row of `win`:
//   win[w] = (ts, tn, s0, l0, s1, l1, ...): targets tgt[ts .. ts + tn),
//   tn <= kThreads kTargets, against the source rows src[s .. s + l) of each
//   of its n_strips strips
// (27 cell runs of the cell-sorted bodies, each cut to its kept count, or the
// one run of live residual rows). The TPU's materialised [C, 8, 27 K8] source
// block, its [C, K8, 8] target block, the 128-lane padding and the epilogue
// gather through the inverse sort do not exist here.
//
// Design: kThreads = 128 threads a block, kTargets = 2 targets a thread,
// thread l holding targets 2 l and 2 l + 1 of its item, so that each source
// row staged in shared memory (kTile at a time) serves two targets, and a
// partly filled item's idle threads sit together in whole warps that skip
// the pair loop. 4 targets a thread ran 10-25% slower at the path's shapes
// (64 registers, and items of 512 targets half empty where a bucket holds
// 768 rows; PERF.md). The law is pair_base_unmasked of pp_law.cuh: one MUFU
// each for rsqrt (rsqrt.approx.ftz where eps^2 >= FLT_MIN, guarded rsqrtf
// below, eps = 0 included), ex2 and rcp; times m_j, then keep_pair's one
// select for r^2 > 0 and m_j > 0 (as `?:` the compiler branched around the
// law a source: 6 more instructions a pair, 17-21% slower). A thread sums a
// tile into partials and adds them to its running totals.
//
// The main pass writes G acc straight to body order, row tgt_out[ts + t] of
// `out` (none where it is < 0): targets map to distinct rows, so there are
// no atomics. The residual-residual block is one strip of up to M live
// rows, too few items to fill the card (at the 1M merger 310 of 464 hold a
// live residual), so it also splits the strip into `runs` runs of whole
// tiles, a second grid dimension (the wrapper sizes it from M alone). Block
// (w, r) writes its raw sums to part[r, ts + t, :]; pp_short_combine adds a
// target's live runs in run order, times G, to its output row. Items past
// the live residuals (tn = 0) and runs past them exit at once; the combine
// skips the same runs. The same inputs give the same bits.
//
// Bound: once a tile is staged a pair costs no device-memory traffic: 3
// differences, r^2 (3), the law (15 FP32 instructions), its 3 MUFU, the
// weight and its select (3), the sum (3), half a shared load: 29.75 issue
// slots a pair in the compiled loop, against the SFU's 16 results a clock an
// SM, which make 3 MUFU the time of 24 issue slots. Issue binds first.

#include <cfloat>
#include <climits>
#include <cuda_runtime.h>

#include "pp_law.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block (ops/ppkernel.py THREADS)
constexpr int kTargets = 2;    // targets a thread (ops/ppkernel.py TARGETS)
constexpr int kTile = 256;     // source rows staged at a time in shared memory

struct Pass {
  const float4* tgt;   // target rows (x, y, z, m)
  const int* tgt_out;  // [tgt_rows] output row of each target, < 0 = none
  const float4* src;   // source rows (x, y, z, m)
  const int* win;      // [n_win, 2 + 2 n_strips] work items
  float* out;          // [n_out, 3]
  float* part;         // [runs, tgt_rows, 3]: a split pass's sums; null for one run
  int n_strips;
  int tgt_rows;
  int run_len;  // sources a run: whole tiles, INT_MAX for one run
};

template <bool kFtz>
__global__ void __launch_bounds__(kThreads)
pp_short_kernel(Pass p, nbx_pp::Law law) {
  __shared__ float4 tile[kTile];
  const int* wd = p.win + static_cast<size_t>(blockIdx.x) * (2 + 2 * p.n_strips);
  const int ts = wd[0];
  const int tn = wd[1];
  const int lo = blockIdx.y * p.run_len;  // 0 for one run
  if (tn <= 0 || (p.part != nullptr && lo >= wd[3])) return;  // the whole block: no live target or source
  const nbx_pp::LawApprox la = nbx_pp::approx_of(law);
  const int t0 = threadIdx.x * kTargets;
  const bool active = t0 < tn;
  float xi[kTargets], yi[kTargets], zi[kTargets], ax[kTargets], ay[kTargets], az[kTargets];
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const float4 q = t0 + t < tn ? p.tgt[ts + t0 + t] : make_float4(0.f, 0.f, 0.f, 0.f);
    xi[t] = q.x;
    yi[t] = q.y;
    zi[t] = q.z;
    ax[t] = ay[t] = az[t] = 0.f;
  }
  for (int s = 0; s < p.n_strips; ++s) {
    const int ss = wd[2 + 2 * s];
    const int hi = min(wd[3 + 2 * s], lo + p.run_len);
    for (int c0 = lo; c0 < hi; c0 += kTile) {  // the same trip count for every thread
      const int nc = min(kTile, hi - c0);
      __syncthreads();  // every thread is done with the previous tile
      for (int l = threadIdx.x; l < nc; l += kThreads) tile[l] = p.src[ss + c0 + l];
      __syncthreads();
      if (!active) continue;
      float px[kTargets], py[kTargets], pz[kTargets];
#pragma unroll
      for (int t = 0; t < kTargets; ++t) px[t] = py[t] = pz[t] = 0.f;
#pragma unroll 4
      for (int k = 0; k < nc; ++k) {
        const float4 q = tile[k];
#pragma unroll
        for (int t = 0; t < kTargets; ++t) {
          const float dx = q.x - xi[t];
          const float dy = q.y - yi[t];
          const float dz = q.z - zi[t];
          const float r2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
          const float w = nbx_pp::keep_pair(q.w * nbx_pp::pair_base_unmasked<kFtz>(r2, la), r2, q.w);
          px[t] = __fmaf_rn(w, dx, px[t]);
          py[t] = __fmaf_rn(w, dy, py[t]);
          pz[t] = __fmaf_rn(w, dz, pz[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kTargets; ++t) {
        ax[t] += px[t];
        ay[t] += py[t];
        az[t] += pz[t];
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int row = ts + t0 + t;
    if (t0 + t >= tn) break;
    if (p.part != nullptr) {
      float* r = p.part + (static_cast<size_t>(blockIdx.y) * p.tgt_rows + row) * 3;
      r[0] = ax[t];
      r[1] = ay[t];
      r[2] = az[t];
    } else if (const int o = p.tgt_out[row]; o >= 0) {
      float* r = p.out + static_cast<size_t>(o) * 3;
      r[0] = law.g * ax[t];
      r[1] = law.g * ay[t];
      r[2] = law.g * az[t];
    }
  }
}

// Thread (w, t): target t of item w of a split pass. Its live runs (those
// that start before the end of its strip, as the pair kernel decides), added
// in run order, times G, to its output row.
__global__ void pp_short_combine(Pass p, float g, int item, int n_win, int runs) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = idx / item;
  if (w >= n_win) return;
  const int* wd = p.win + static_cast<size_t>(w) * (2 + 2 * p.n_strips);
  const int t = idx - w * item;
  if (t >= wd[1]) return;
  const int row = wd[0] + t;
  const int o = p.tgt_out[row];
  if (o < 0) return;
  const int live = min(runs, (wd[3] + p.run_len - 1) / p.run_len);
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int r = 0; r < live; ++r) {
    const float* q = p.part + (static_cast<size_t>(r) * p.tgt_rows + row) * 3;
    sx = r == 0 ? q[0] : __fadd_rn(sx, q[0]);
    sy = r == 0 ? q[1] : __fadd_rn(sy, q[1]);
    sz = r == 0 ? q[2] : __fadd_rn(sz, q[2]);
  }
  float* out = p.out + static_cast<size_t>(o) * 3;
  out[0] = g * sx;
  out[1] = g * sy;
  out[2] = g * sz;
}

}  // namespace

// Plain C entry point, loaded with ctypes. tgt [tgt_rows] and tgt_out
// [tgt_rows], src, win [n_win, 2 + 2 n_strips], out [n_out, 3] zeroed by the
// caller; `item` = kThreads kTargets, the most targets an item holds (the
// wrapper's ITEM). runs > 1 splits the one strip of each item (n_strips 1)
// into runs of run_len sources (whole tiles) and needs float32 scratch part
// [runs, tgt_rows, 3]; then a second launch adds the runs. Launches on
// `stream` and returns the launches' cudaError_t (0 on success); it does
// not synchronise.
extern "C" int nbx_pp_short(const void* tgt, const void* tgt_out, const void* src, const void* win, void* out,
                            void* part, int tgt_rows, int n_win, int n_strips, int item, int runs, int run_len,
                            float eps2, float inv_a, float c_a, float g, void* stream) {
  if (n_win <= 0) return static_cast<int>(cudaSuccess);
  if (n_strips < 0 || runs <= 0 || item != kThreads * kTargets) return static_cast<int>(cudaErrorInvalidValue);
  if (runs > 1 && (n_strips != 1 || part == nullptr || run_len <= 0 || run_len % kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  const Pass pass{static_cast<const float4*>(tgt), static_cast<const int*>(tgt_out),
                  static_cast<const float4*>(src), static_cast<const int*>(win), static_cast<float*>(out),
                  runs > 1 ? static_cast<float*>(part) : nullptr, n_strips, tgt_rows, runs > 1 ? run_len : INT_MAX};
  const nbx_pp::Law law{eps2, inv_a, c_a, g};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto kernel = eps2 >= FLT_MIN ? pp_short_kernel<true> : pp_short_kernel<false>;
  kernel<<<dim3(n_win, runs), kThreads, 0, st>>>(pass, law);
  if (runs > 1) {
    constexpr int kCombine = 256;
    const int threads = n_win * item;
    pp_short_combine<<<(threads + kCombine - 1) / kCombine, kCombine, 0, st>>>(pass, g, item, n_win, runs);
  }
  return static_cast<int>(cudaGetLastError());
}
