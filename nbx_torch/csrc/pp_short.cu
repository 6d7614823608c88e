// K4: the P3M short-range pair pass, float32, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_pp_kernel` of nbx/ops/ppkernel.py:59, as launched
// by `short_range_acc_pallas` (:259, the main pass, uniform or
// occupancy-bucketed cells) and `residual_rr_dense_pallas` (:600, the dense
// residual-residual block). It keeps that kernel's contract, not its blocks:
// each kept target against the kept bodies of its 27 neighbour cells, or each
// residual row against every residual row, with the law and masks of
// pp_law.cuh.
//
// Design: the caller (nbx_torch/ops/ppkernel.py) hands one work item per
// thread block: a run of at most `threads` targets and the strips of source
// rows it meets (27 cell runs of the cell-sorted bodies, each cut to its kept
// count, or the one run of live residual rows). Sources are read straight
// from the float4 (x, y, z, m) rows, staged 256 at a time in shared memory;
// the TPU's materialised [C, 8, 27 K8] source block, its [C, K8, 8] target
// block, the 128-lane padding and the epilogue gather through the inverse
// sort do not exist here. Each target writes its row of the output straight
// to body order through tgt_out, so there are no atomics and the result is
// deterministic. Bodies past the kept count, and the cells a bucket drops,
// are no item's targets and keep the 0 the wrapper writes.
//
// Bound: a pair costs no device-memory traffic once its tile is staged, about
// 40 FP32 operations and three special-function results (rsqrt, ex2 inside
// expf, the reciprocal of 1 + p x). The SFU gives 16 results per clock per SM
// against 128 FP32 lanes, so 3 SFU results weigh as much as 24 FP32 lanes:
// the pass is bound by the throughput of both, not by bytes. Splitting a cell's
// sources over warps, cp.async staging and several targets per thread are
// for later changes; this version is the simple, correct one.

#include "pp_law.cuh"

namespace {

__global__ void __launch_bounds__(nbx_pp::kMaxThreads)
pp_short_kernel(nbx_pp::Pass pass, nbx_pp::Law law) {
  nbx_pp::run_item(pass, blockIdx.x, law);
}

}  // namespace

// Plain C entry point, loaded with ctypes. One block of `threads` threads (a
// multiple of 32, at most 256) per work item. Launches on `stream` and
// returns the launch's cudaError_t (0 on success); it does not synchronise.
extern "C" int nbx_pp_short(const void* tgt, const void* tgt_out, const void* src,
                            const void* win, void* out, int n_win, int n_strips, int threads,
                            float eps2, float inv_a, float c_a, float g, void* stream) {
  if (n_win <= 0) return static_cast<int>(cudaSuccess);
  if (n_strips < 0 || nbx_pp::bad_threads(threads)) return static_cast<int>(cudaErrorInvalidValue);
  const nbx_pp::Pass pass{static_cast<const float4*>(tgt), static_cast<const int*>(tgt_out),
                          static_cast<const float4*>(src), static_cast<const int*>(win),
                          static_cast<float*>(out), n_win, n_strips};
  pp_short_kernel<<<n_win, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      pass, nbx_pp::Law{eps2, inv_a, c_a, g});
  return static_cast<int>(cudaGetLastError());
}
