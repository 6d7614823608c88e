// K5: the P3M residual-versus-table pass, both directions, float32, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_pp_react_kernel` of nbx/ops/ppkernel.py:143, as
// launched by `residual_table_acc_pallas` (:681): each residual row against
// the kept bodies of every affected cell (the 27-dilation of the overflowing
// cells), giving the residual its force and each kept body the reaction
// -G sum_t wbase(t, j) m_t d_tj.
//
// Design: the TPU kernel sums the reaction as column sums over its target
// blocks, carried in a [8, S] output block that the grid revisits in order.
// Thread blocks of this card run in no order, so a column sum would need
// atomics (and a sum whose order changes from run to run). The reaction is
// instead K4's law with targets and sources swapped, 0 wherever m_t = 0, so
// it is a row sum too. One launch runs two passes of work items (pp_law.cuh):
//   the forward pass: targets = the live residual rows, sources = the kept
//   runs of the affected cells, each residual written to its body's row;
//   the reaction pass: targets = the kept rows of each affected cell,
//   sources = the live residual rows, each written to its body's row.
// The two target sets are disjoint bodies, so both passes write one output
// without atomics, and the result is deterministic. The first fwd.n_win blocks
// run forward items, the rest reaction items. The cost: each pair is
// evaluated twice, once per direction, where the TPU kernel shared one
// evaluation between them.
//
// Bound: as K4 (pp_short.cu), FP32 and special-function throughput, here on
// 2 x live residuals x affected kept bodies pair evaluations.

#include "pp_law.cuh"

namespace {

__global__ void __launch_bounds__(nbx_pp::kMaxThreads)
pp_react_kernel(nbx_pp::Pass fwd, nbx_pp::Pass react, nbx_pp::Law law) {
  if (static_cast<int>(blockIdx.x) < fwd.n_win) {  // the same branch for the whole block
    nbx_pp::run_item(fwd, blockIdx.x, law);
  } else {
    nbx_pp::run_item(react, blockIdx.x - fwd.n_win, law);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. The forward pass's arguments, then
// the reaction pass's, each (tgt, tgt_out, src, win, out, n_win, n_strips);
// one block of `threads` threads (a multiple of 32, at most 256) per work
// item. Launches on `stream` and returns the launch's cudaError_t (0 on
// success); it does not synchronise.
extern "C" int nbx_pp_react(const void* f_tgt, const void* f_tgt_out, const void* f_src,
                            const void* f_win, void* f_out, int f_n_win, int f_n_strips,
                            const void* r_tgt, const void* r_tgt_out, const void* r_src,
                            const void* r_win, void* r_out, int r_n_win, int r_n_strips,
                            int threads, float eps2, float inv_a, float c_a, float g,
                            void* stream) {
  const int blocks = f_n_win + r_n_win;
  if (blocks <= 0) return static_cast<int>(cudaSuccess);
  if (f_n_win < 0 || r_n_win < 0 || f_n_strips < 0 || r_n_strips < 0 ||
      nbx_pp::bad_threads(threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const nbx_pp::Pass fwd{static_cast<const float4*>(f_tgt), static_cast<const int*>(f_tgt_out),
                         static_cast<const float4*>(f_src), static_cast<const int*>(f_win),
                         static_cast<float*>(f_out), f_n_win, f_n_strips};
  const nbx_pp::Pass react{static_cast<const float4*>(r_tgt), static_cast<const int*>(r_tgt_out),
                           static_cast<const float4*>(r_src), static_cast<const int*>(r_win),
                           static_cast<float*>(r_out), r_n_win, r_n_strips};
  pp_react_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      fwd, react, nbx_pp::Law{eps2, inv_a, c_a, g});
  return static_cast<int>(cudaGetLastError());
}
