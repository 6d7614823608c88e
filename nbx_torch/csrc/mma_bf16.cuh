// The bf16 tensor-core pieces of the direct sums that run their products as
// mma.sync.aligned.m16n8k16 (sm_90a): "mxu" (pairwise_mxu.cu, K1c) and
// "fast" (pairwise_fast.cu, K1b); `bits` and `bf162` also serve "bf16"'s
// packed registers (pairwise_precision.cu, K1e).
//
// Fragments of m16n8k16 (a warp; lane l, grp = l / 4, quad = l % 4):
//   A, 16 x 16 row-major: a0 (row grp, columns 2 quad, 2 quad + 1), a1 (row
//     grp + 8, the same columns), a2 and a3 (the same rows, columns + 8);
//   B, 16 x 8 column-major: b0 (rows 2 quad, 2 quad + 1 of column grp), b1
//     (rows + 8);
//   D, 16 x 8 float32: d0, d1 (row grp, columns 2 quad, 2 quad + 1), d2, d3
//     (row grp + 8).
// So a lane computes the A values of its two rows at columns 2 quad + {0, 1}
// and + {8, 9}, and finds its D values of columns 2 quad, 2 quad + 1.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace nbx_mma {

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bf162(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// hi = bf16(v), lo = bf16(v - hi) of two neighbouring values of an A
// fragment row, each pair packed as one register (the lower column in the
// low half).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(a, __low2float(h)), __fsub_rn(b, __high2float(h))));
}

// d += A B: A 16 x 16 bf16 (row-major fragment a0-a3), B 16 x 8 bf16
// (column-major fragment b0, b1), d 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace nbx_mma
