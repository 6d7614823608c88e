// The float32-to-bf16 conversion rate of the card, for NVIDIA Hopper
// (sm_90a): a timed loop of conversions and nothing else, read by
// nbx_torch/bench/cvt_rate.py. Not a kernel of any path: it measures the
// rate at which the bounds of "bf16", "fast" and "mxu" (chip_smoke.py) count
// their conversions.
//
// Each thread runs kChains independent chains, each conversion's result the
// next one's input (bits reread as a float32, no instruction), so that
// nothing but the conversions and the loop's counter issues:
//
//   packed  cvt.rn.bf16x2.f32: one F2FP rounds two float32 values;
//   scalar  cvt.rn.bf16.f32: one F2FP rounds one (its other half zero).
//
// 1,024 threads a block, 8 chains a thread (64 independent conversions a
// scheduler), so the conversions' latency is hidden. Thread 0 of each block
// records the SM's clock (clock64) after a barrier before and after the
// loop, and the SM it ran on (%smid): the caller adds the conversions of the
// blocks that shared an SM and divides by that SM's span of clocks.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kChains = 8;

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
cvt_loop(uint32_t* __restrict__ sink, long long* __restrict__ start, long long* __restrict__ stop,
         int* __restrict__ sm, int iters) {
  float x[kChains], y[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    x[k] = 1.f + 1e-3f * static_cast<float>(threadIdx.x * kChains + k);
    y[k] = 2.f - 1e-3f * static_cast<float>(k);
  }
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if constexpr (kPacked) {
        uint32_t r;
        asm volatile("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(x[k]), "f"(y[k]));
        x[k] = __uint_as_float(r);
      } else {
        unsigned short h;
        asm volatile("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(x[k]));
        x[k] = __uint_as_float(h);
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) acc ^= __float_as_uint(x[k]);
  sink[blockIdx.x * kThreads + threadIdx.x] = acc;
  if (threadIdx.x == 0) {
    int id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    start[blockIdx.x] = t0;
    stop[blockIdx.x] = t1;
    sm[blockIdx.x] = id;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes: `blocks` blocks of 1,024 threads,
// each running 8 chains of `iters` conversions (packed != 0: bf16x2).
// `sink` [blocks x 1024] uint32, `start`, `stop` [blocks] int64 (clock64),
// `sm` [blocks] int32. Launches on `stream` and returns the launch's
// cudaError_t (0 on success); does not synchronise.
extern "C" int nbx_cvt_rate(int packed, void* sink, void* start, void* stop, void* sm, int blocks, int iters,
                            void* stream) {
  if (blocks <= 0 || iters <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* s = static_cast<uint32_t*>(sink);
  auto* t0 = static_cast<long long*>(start);
  auto* t1 = static_cast<long long*>(stop);
  auto* id = static_cast<int*>(sm);
  if (packed) {
    cvt_loop<true><<<blocks, kThreads, 0, st>>>(s, t0, t1, id, iters);
  } else {
    cvt_loop<false><<<blocks, kThreads, 0, st>>>(s, t0, t1, id, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
