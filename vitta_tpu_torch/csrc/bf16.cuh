// bfloat16 tensor-core products for Hopper (sm_90a), the neighbour of
// tf32.cuh: the bfloat16 window attention's (attention_kernels.cuh), and the
// rounding and packing helpers the bfloat16 matrix product
// (gemm_wgmma_bf16.cuh) shares.
//
// mma.sync.m16n8k16 takes bfloat16 operands and adds their products to a
// float32 accumulator.  A product of two bfloat16 values (8 significant
// bits each) is exact in float32, so one tensor-core product per fragment
// gives what vitta_tpu's dot_general(bf16, bf16, preferred_element_type=
// float32) gives, up to the order of the float32 additions: no split, as
// the float32 kernels need (3xTF32, tf32.cuh).  The tensor cores still add
// into their accumulator with truncation, so a long sum takes fresh
// accumulators per staged slice (gemm_tiles.cuh).
//
// Fragments of m16n8k16 (g = lane / 4, t = lane % 4), each register two
// bfloat16 values, the lower column first:
//   A (16 x 16): a0 (row g, cols 2t, 2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..),
//                a3 (g + 8, 2t+8..);
//   B (16 x 8):  b0 (rows k = 2t, 2t+1, col g), b1 (k = 2t+8, 2t+9, col g);
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t+1), c2 (g + 8, 2t), c3 (g + 8, 2t+1),
// float32.  Two neighbouring C tiles over 8 + 8 columns, rounded to bfloat16
// in pairs, are an A fragment over those 16 columns as it stands
// (c0c1 of the first -> a0, c2c3 -> a1, of the second -> a2, a3).

#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace vitta {

using bf16 = __nv_bfloat16;

// (lo, hi) rounded to nearest even and packed, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 matrices of 16-bit values from shared memory (rows 16-byte
// aligned): lane l gives the address of row l % 8 of matrix l / 8 and
// receives in r[q] the pair (row l / 4, cols 2 (l % 4), 2 (l % 4) + 1) of
// matrix q.  With matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15) of a [row][k] tile that is the A fragment; with
// (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) of a
// [n][k] tile, the B fragments of two neighbouring 8-column tiles.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same, each matrix transposed: from a [k][row] tile (the contraction
// index the row of shared memory) lane l receives the pair (row l / 4 of
// the transposed matrix, k 2 (l % 4), 2 (l % 4) + 1).  With matrices
// (k 0-7, rows 0-7), (k 0-7, rows 8-15), (k 8-15, rows 0-7),
// (k 8-15, rows 8-15) that is the A fragment of a k-major A; with
// (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15), the B
// fragments of two neighbouring 8-column tiles of a k-major B.
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// cp.async of 16 bytes (8 bfloat16 values) from global to shared memory;
// without `full` the bytes are zeros and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

}  // namespace vitta
