// bf16 tensor-core helpers shared by the flash-attention kernels: one
// mma.sync.m16n8k16 step with float32 accumulation, and the 32-bit packing
// and shared-memory loads its fragments are made of.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16x8, B[k][n]):    b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16x8, float32):    c[e] = C[g + 8*(e >> 1)][2t + (e & 1)]
// so a row-major tile whose rows are the n index (K for q k^T) gives B
// fragments as 32-bit loads, and two C tiles side by side, rounded to bf16,
// are the A fragment of the next product over their columns.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace
