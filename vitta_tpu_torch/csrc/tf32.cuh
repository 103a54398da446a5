// Split-TF32 tensor-core products and cp.async staging for Hopper (sm_90a),
// shared by the matrix product (gemm_tiles.cuh) and the window attention
// (attention_kernels.cuh).
//
// mma.sync.m16n8k8 takes tf32 operands (10 explicit mantissa bits) and adds
// their products to a float32 accumulator.  One tf32 product keeps about
// three decimal digits, which the float32 tolerances of the port's kernels
// do not allow, so every operand x is split into two tf32 values,
// x = hi + lo to about 2^-21 of x, and a b is computed as lo*hi + hi*lo +
// hi*hi ("3xTF32"): float32 accuracy at three tensor-core products.
// tests/test_torch_attention_tf32.py and tests/test_torch_gemm_tf32.py
// emulate this arithmetic on the CPU.

#pragma once
#include <cuda_runtime.h>

namespace vitta {

// x = hi + lo to about 2^-21 of x, hi and lo tf32 values (10 mantissa
// bits): hi rounded to nearest, ties away from zero (what cvt.rna.tf32.f32
// gives, in two integer operations, which issue faster than the
// conversion), x - hi exact in float32, lo that remainder cut to tf32.
// The cut costs nothing: mma.sync reads a tf32 operand's 19 high bits and
// ignores the 13 low ones (as CUTLASS's round-toward-zero tf32 conversion,
// a plain reinterpretation, relies on), so lo is passed as it is.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Operands of mma.m16n8k8 with tf32 inputs, each split in two.  A (16 x 8):
// a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// B (8 x 8): b0 (row t, col g), b1 (t + 4, g); the accumulator (16 x 8):
// c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1); g is the
// lane's group (lane / 4) and t its place in it (lane % 4).
struct FragA {
  unsigned hi[4], lo[4];
};
struct FragB {
  unsigned hi[2], lo[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b at float32 accuracy: three tf32 products (lo hi, hi lo, hi hi,
// the small terms first); the lo lo term is below float32's rounding.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// The four 8 x 4 quarters of a 16 x 8 tile of 32-bit values in shared
// memory (rows 16-byte aligned) as ldmatrix.x4 hands them out, viewing a
// row of four floats as eight 16-bit halves: lane l gives the address of
// row l % 8 of quarter l / 8, and receives in r[q] element (l / 4, l % 4) of
// quarter q.  With quarters (rows 0-7, cols 0-3), (8-15, 0-3), (0-7, 4-7),
// (8-15, 4-7) that is mma's A fragment a0 .. a3; with (0-7, 0-3),
// (0-7, 4-7), (8-15, 0-3), (8-15, 4-7) of a [n][k] tile, the B fragments
// b0, b1 of two neighbouring 8-column tiles.
__device__ __forceinline__ void ldmatrix_x4(float (&r)[4], const float* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  unsigned u[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3])
      : "r"(s));
#pragma unroll
  for (int e = 0; e < 4; ++e) r[e] = __uint_as_float(u[e]);
}

// cp.async of kBytes from global to shared memory; without `full` the bytes
// are zeros and nothing is read.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
                 "l"(src), "r"(full ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(s),
                 "l"(src), "n"(kBytes), "r"(full ? kBytes : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are still
// in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

}  // namespace vitta
