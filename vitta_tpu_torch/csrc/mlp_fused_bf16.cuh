// The bfloat16 MLP without the LayerNorm for Hopper (sm_90a), row by row:
// the forward in one launch that keeps the GELU's value a on chip, and the
// backward's row pass (dh, dhc, dx and the bias gradients' partials) in one
// launch (mlp.cu's vitta_mlp_{fwd,bwd}_bf16 at Video Swin-T's and Swin-S's
// widths).
//
// Replaces, with mlp.cu, the Pallas TPU kernels of vitta_tpu/ops/
// pallas_mlp.py at the compute dtype: _fwd_kernel (:138), launched by
// _pallas_mlp_fwd (:192), and the row part of _bwd_kernel (:154), launched
// by _pallas_mlp_bwd (:222).  On x, g (M, C) with the weights in
// torch.nn.Linear layout (w1 (F, C), w2 (C, F)):
//   forward    h = x w1^T + b1 (float32), a = gelu(h), s = gelu'(h) (each
//              rounded once), o = bfloat16(a) w2^T + b2 rounded once;
//   row pass   dh = (g w2) * s (float32), dhc = bfloat16(dh) (to device
//              memory for dw1), dx = dhc w1 rounded once, and the column
//              sums of dh (db1's partials) and of g (db2's).
// mlp.cu runs dw1 = dhc^T x and dw2 = g^T a on the shared core
// (gemm_wgmma_bf16.cuh, wgmma_grads) and adds every partial in order in
// one reduce_sums launch.
//
// What bounds it: bytes, and the GELU on the float32 lanes.  At C = 96 /
// F = 384 a call moves x, o and, when the backward will need them, a and
// s: 4 M F + 4 M C bytes; its 4 M C F operations take a quarter of that
// time on the tensor cores, while the GELU's erff (some 35 instructions a
// value, two of them MUFU) takes about as long as the bytes.  The TPU
// kernel keeps a in VMEM between its two products; the shared core's chain
// wrote a to device memory and read it back (40% of a call's bytes) and
// spent a quarter of its o product on the zero columns of a 128-wide tile
// at C = 96.  The design:
// * Tiles.  A block walks tiles of 128 rows (persistent, min(tiles, SMs)
//   blocks); two consumer warpgroups take 64 rows each, a producer
//   warpgroup's one thread issues every TMA load.  The tile's x (or g)
//   stays in shared memory for the whole of F.
// * F in chunks of 64, three rings.  A holds the first product's weight
//   chunk, B the second's: w1's 64 rows (K-major for h, MN-major for dx)
//   and w2's 64 columns (K-major for o, MN-major for da = g w2), the same
//   64 x 64 boxes in both directions; S, in the backward, the chunk of s of
//   both warpgroups.  The first product (h, or da) runs over K = C in
//   place on wgmma.m64n64k16; its epilogue (gelu_parts_bf16, or the
//   product with s) works in registers.  The rounded chunk (a, or dhc)
//   goes into shared memory in the 128-byte-swizzled K-major layout TMA
//   writes (conflict-free 4-byte stores), fence.proxy.async, then the
//   second product (o, or dx) reads it as wgmma's A operand with N = C
//   exactly (wgmma.m64n{48,96,192}k16): no zero columns, summed in place
//   over all of F (at K = 384 and 768 within the one-ulp checks; the
//   truncating sums first missed a tolerance at K = 2048).
// * Overlap.  A warpgroup waits on each product as soon as it is issued
//   (mf_chunk); the two warpgroups of a block, and the producer's loads and
//   the TMA stores, overlap each other.  Pipelining a warpgroup's own
//   chunks (issuing the next first product before this epilogue, waiting
//   on the second two chunks later) timed no faster on the card.
// * Stores.  a and s (forward, only where the backward needs them) and dhc
//   (backward) go from the swizzled buffers to device memory by TMA stores;
//   rows past M are clipped by TMA.
//   o and dx are stored from the running sums, rounded once, the rows past
//   M masked.  The forward without residuals writes nothing (M, F).
// * Bias gradients.  db1's sum over 64 rows of a chunk: each thread adds
//   its two rows of dh, the eight row groups of a warp meet in a butterfly
//   (__shfl_xor over 4, 8, 16), the four warps in order.  db2's: the g
//   tile's columns over its 64 rows, row by row in order.  Each warpgroup
//   adds these over its tiles in order in shared memory and writes one row
//   of each at the end (two rows a block); mlp.cu's reduce adds the rows
//   in order: no atomics, the same bits every run.
//
// The instances take C in {48, 96, 192} and F = 4C (mlp_fused);
// mlp.cu runs other widths on the shared core's chain.  Every pointer must
// be 16-byte aligned.

#pragma once
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_wgmma_bf16.cuh"

namespace vitta {

// wgmma.m64nNk16 with float32 sums of bfloat16 operands from shared memory
// (TA / TB 1 where that operand is MN-major): d (64 x N, this warpgroup's
// fragment: d[4 j + 2 h + e] at row 16 warp + lane / 4 + 8 h, column
// 8 j + 2 (lane % 4) + e) = A B (+ d where acc is not 0).
template <int N>
struct Wgmma;

template <>
struct Wgmma<48> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma(float (&d)[24], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<96> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<192> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};


constexpr int kMfRows = 128;       // rows of a tile: two warpgroups of 64
constexpr int kMfChunk = 64;       // columns of F a chunk
constexpr int kMfThreads = 384;    // two consumer warpgroups, one producer
constexpr int kMfSmemMax = 232448; // dynamic shared memory of a block
constexpr int kMfMaxSlots = 4;     // slots of a ring at most
constexpr int kMfBarBytes = 8 * (2 * 3 * kMfMaxSlots + 4);

// A block's rings' slots: A, S, B (see MfShape).
struct MfSlots {
  int a, s, b;
};

// Whether the fused kernels take widths (c, f): Swin's MLP ratio of 4.
inline bool mlp_fused(int c, int f) {
  return (c == 48 || c == 96 || c == 192) && f == 4 * c;
}

// The bytes of a block of width c with slots q: fixed (the x or g tile,
// each warpgroup's store buffers, the row pass's per-warp column sums and
// its two warpgroups' running column sums of dh (4c) and g (c), the
// mbarriers, the slack) plus the rings.
constexpr int mf_fixed(int c, bool bwd) {
  return 1024 + 2 * ((c + 63) / 64) * kWgBoxBytes +
         2 * (bwd ? 1 : 2) * kWgBoxBytes +
         (bwd ? 2 * 4 * kMfChunk * 4 + 2 * 5 * c * 4 : 0) + kMfBarBytes;
}
constexpr int mf_bytes(int c, bool bwd, MfSlots q) {
  return mf_fixed(c, bwd) + (q.a + q.b) * ((c + 63) / 64) * kWgBoxBytes +
         q.s * 2 * kWgBoxBytes;
}
// Each ring starts at 4 slots (S only in the backward); while the block's
// shared memory is too large, the ring with the most slots gives one up (A
// first, then S, B last on a tie).
constexpr MfSlots mf_fit(int c, bool bwd) {
  MfSlots q{kMfMaxSlots, bwd ? kMfMaxSlots : 0, kMfMaxSlots};
  while (mf_bytes(c, bwd, q) > kMfSmemMax) {
    const int most =
        q.a > q.s ? (q.a > q.b ? q.a : q.b) : (q.s > q.b ? q.s : q.b);
    if (q.a == most)
      --q.a;
    else if (q.s == most)
      --q.s;
    else
      --q.b;
  }
  return q;
}

// The shared memory of an instance: the x (or g) tile of both warpgroups;
// each warpgroup's store buffers (the forward: a and s; the row pass: dhc);
// three rings: A, the first product's weight
// chunk (w1's rows forward, w2's columns backward), S, the backward's
// chunk of s of both warpgroups, and B, the second product's (w2's columns
// forward, w1's rows backward); the row pass's per-warp column sums and
// running column sums; the mbarriers; 1024 bytes of slack align the boxes
// to the swizzle's atoms.
template <int C, bool BWD>
struct MfShape {
  static constexpr int nc = (C + 63) / 64;              // boxes across C
  static constexpr int x_bytes = 2 * nc * kWgBoxBytes;
  static constexpr int buf_bytes = (BWD ? 1 : 2) * kWgBoxBytes;  // a wg
  static constexpr int sums_bytes = BWD ? 2 * 4 * kMfChunk * 4 : 0;
  static constexpr int acc_floats = BWD ? 5 * C : 0;    // a wg's db1, db2
  static constexpr int a_bytes = nc * kWgBoxBytes;      // a slot of A or B
  static constexpr int s_bytes = 2 * kWgBoxBytes;       // a slot of S
  static constexpr int slots_a = mf_fit(C, BWD).a;
  static constexpr int slots_s = mf_fit(C, BWD).s;
  static constexpr int slots_b = mf_fit(C, BWD).b;
  static constexpr int smem = mf_bytes(C, BWD, mf_fit(C, BWD));
  // byte offsets from the block's aligned base
  static constexpr int bufs_off = x_bytes;
  static constexpr int ring_a_off = bufs_off + 2 * buf_bytes;
  static constexpr int ring_s_off = ring_a_off + slots_a * a_bytes;
  static constexpr int ring_b_off = ring_s_off + slots_s * s_bytes;
  static constexpr int sums_off = ring_b_off + slots_b * a_bytes;
  static constexpr int caccs_off = sums_off + sums_bytes;
  static constexpr int bars_off = caccs_off + 2 * acc_floats * 4;
  static constexpr int xfull_off = bars_off, xempty_off = bars_off + 16;
  // the producer warpgroup keeps 40 registers a thread, the consumers share
  // the rest (232 at 384 threads)
  static constexpr int regs_consumer =
      ((65536 / kMfThreads / 8 * 8) * 3 - 40) / 2 / 8 * 8;
  static_assert(slots_a >= 2 && slots_b >= 2 && (!BWD || slots_s >= 2),
                "two slots a ring at least");
  static_assert(smem <= kMfSmemMax, "shared memory of a block");
  static_assert(C % 16 == 0 && C <= 192, "wgmma's N and the registers");
};

// What a launch computes besides its tensor maps.  Forward: bias b1, b2;
// out o (M, C); residuals: a and s are stored (their maps).  Row pass: out
// dx (M, C); dh_tap (M, F) float32 or null; part1 (2 grid, F) and part2
// (2 grid, C): row 2 b + w holds warpgroup w of block b's column sums of
// dh and g over its tiles, each tile's 64 rows summed, then added in the
// block's order of tiles.
struct MfArgs {
  const bf16* b1;
  const bf16* b2;
  bf16* out;
  float* dh_tap;
  float* part1;
  float* part2;
  int M, F, residuals;
};

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// at most N of this thread's store groups still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// generic-proxy writes to shared memory made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The byte offset of (row r, the 16-byte unit u) in a 64 x 64 bfloat16 box
// under the 128-byte swizzle: rows of 128 bytes, unit u of row r at
// u ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return (uint32_t)(r * 128 + ((u ^ (r & 7)) << 4));
}

// A ring of SLOTS slots of BYTES in shared memory at byte DATA from the
// block's aligned base, its mbarriers at BAR ("full" a slot, then "empty"
// a slot, 4 of each), each slot filled by the producer's TMA loads on its
// "full" mbarrier and handed back on its "empty" one, by every consumer
// warp (8 arrivals) where only wgmma reads it, by every consumer thread
// (S).  All but the slot and the phase of the next use are constants of
// the instance, so a ring costs two registers.
template <int DATA, int BAR, int SLOTS, int BYTES>
struct MfRing {
  static constexpr int slots = SLOTS;
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ uint32_t addr(uint32_t base) const {
    return base + DATA + slot * BYTES;
  }
  __device__ __forceinline__ uint32_t full_bar(uint32_t base) const {
    return base + BAR + 8 * slot;
  }
  __device__ __forceinline__ uint32_t empty_bar(uint32_t base) const {
    return base + BAR + 8 * kMfMaxSlots + 8 * slot;
  }
  __device__ __forceinline__ void next() {
    if (++slot == SLOTS) slot = 0, phase ^= 1;
  }
};

// The rings of an instance: A, S and B, their mbarriers after the x ones.
template <int C, bool BWD>
struct MfRings {
  using S = MfShape<C, BWD>;
  static constexpr int kR = 8 * kMfMaxSlots;      // a ring's mbarriers, bytes
  using A = MfRing<S::ring_a_off, S::bars_off + 32, S::slots_a, S::a_bytes>;
  using Sr = MfRing<S::ring_s_off, S::bars_off + 32 + 2 * kR, S::slots_s,
                    S::s_bytes>;
  using B = MfRing<S::ring_b_off, S::bars_off + 32 + 4 * kR, S::slots_b,
                   S::a_bytes>;
};

// The first product of a chunk, over K = C in place, issued as one group:
// d (64 x 64) from A (the warpgroup's x or g tile, K-major boxes of 64 k at
// a) and B (boxes of 64 k at b: K-major for h, MN-major for da).
template <int C, int TB>
__device__ __forceinline__ void issue_first(float (&d)[32], uint32_t a,
                                            uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk)
    Wgmma<64>::mma<0, TB>(
        d, wg_operand<false>(a + kk / 4 * kWgBoxBytes, kk % 4),
        wg_operand<TB != 0>(b + kk / 4 * kWgBoxBytes, kk % 4), kk > 0);
  wgmma_commit();
}

// The second product of a chunk, its 64 k added in place to d (64 x C):
// A the rounded chunk (K-major, at a), B at b (w2's C rows K-major for o,
// w1's C columns in 64-wide MN-major boxes for dx); one group.
template <int C, int TB>
__device__ __forceinline__ void issue_second(float (&d)[C / 2], uint32_t a,
                                             uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<C>::template mma<0, TB>(d, wg_operand<false>(a, kk),
                                  wg_operand<TB != 0>(b, kk), 1);
  wgmma_commit();
}

// A consumer warpgroup's state between its chunks; its addresses in shared
// memory are constant offsets from base.
template <int C, bool BWD>
struct MfCtx {
  using S = MfShape<C, BWD>;
  const MfArgs* p;
  const CUtensorMap* mf;
  const CUtensorMap* mf2;
  unsigned char* gbase;    // the generic address of `base`
  uint32_t base;
  typename MfRings<C, BWD>::A ra;
  typename MfRings<C, BWD>::Sr rs;
  typename MfRings<C, BWD>::B rb;
  int wg, t, m0;
  bool live;
  __device__ __forceinline__ int warp() const { return t / 32; }
  __device__ __forceinline__ int lane() const { return t % 32; }
  __device__ __forceinline__ int g() const { return t % 32 / 4; }
  __device__ __forceinline__ int tq() const { return t % 4; }
  // this warpgroup's x or g tile, store buffers, mbarrier "x empty"
  __device__ __forceinline__ uint32_t xw() const {
    return base + wg * S::nc * kWgBoxBytes;
  }
  __device__ __forceinline__ uint32_t mybuf() const {
    return base + S::bufs_off + wg * S::buf_bytes;
  }
  __device__ __forceinline__ uint32_t xempty() const {
    return base + S::xempty_off + 8 * wg;
  }
  // its per-warp column sums; then, after both warpgroups' per-warp sums,
  // the running column sums over its tiles of dh (4C floats) and g (C)
  __device__ __forceinline__ float* wsum() const {
    return reinterpret_cast<float*>(gbase + S::sums_off) + wg * 4 * kMfChunk;
  }
  __device__ __forceinline__ float* cacc() const {
    return reinterpret_cast<float*>(gbase + S::caccs_off) + wg * 5 * C;
  }
};

// The GELU of a chunk's h (v without the bias b1), each value rounded into
// the swizzled buffer of a at bp and, with S, of s at sp: a = h Phi(h) as
// gelu_parts_bf16 makes it, whose s is the derivative.
template <bool S>
__device__ __forceinline__ void gelu_chunk(const bf16* b1,
                                           const float (&v)[32],
                                           unsigned char* bp,
                                           unsigned char* sp, int warp, int g,
                                           int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned bw = *reinterpret_cast<const unsigned*>(b1 + 8 * j + 2 * tq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h, r = 16 * warp + g + 8 * h;
      const float h0 = v[i] + bf16_lo(bw), h1 = v[i + 1] + bf16_hi(bw);
      float a0, a1, s0, s1;
      if (S) {
        gelu_parts_bf16(h0, a0, s0);
        gelu_parts_bf16(h1, a1, s1);
        *reinterpret_cast<unsigned*>(sp + swz(r, j) + 4 * tq) =
            pack_bf16(s0, s1);
      } else {
        a0 = h0 * (0.5f * (1.0f + erff(h0 * 0.7071067811865476f)));
        a1 = h1 * (0.5f * (1.0f + erff(h1 * 0.7071067811865476f)));
      }
      *reinterpret_cast<unsigned*>(bp + swz(r, j) + 4 * tq) =
          pack_bf16(a0, a1);
    }
  }
}

// A warpgroup's chunk c once first(c) is in v: the epilogue on the float32
// lanes, the rounded chunk (a, or dhc) into its buffer and out by TMA;
// returns the buffer, the second product's A operand.  The row pass also
// stores the float32 dh where p.dh_tap is not null (for checks).
template <int C, bool BWD>
__device__ __forceinline__ uint32_t mf_epilogue(MfCtx<C, BWD>& x, int c,
                                                float (&v)[32]) {
  const MfArgs& p = *x.p;
  const int t = x.t, warp = x.warp(), g = x.g(), tq = x.tq();
  const int col0 = c * kMfChunk;
  const uint32_t buf = x.mybuf();                           // a, or dhc
  unsigned char* bp = x.gbase + (buf - x.base);
  if (!BWD) {
    // the buffers are free: second(c - 1) is done, and the stores of
    // chunk c - 1 have read them
    const uint32_t sbuf = x.mybuf() + kWgBoxBytes;
    unsigned char* sp = x.gbase + (sbuf - x.base);
    if (t == 0) bulk_wait_read<0>();
    named_sync(1 + x.wg, 128);
    // h + b1, the GELU: a, and s where the backward needs it, rounded
    // into their buffers (without residuals s is not computed: 6% of the
    // eval forward on the card)
    if (p.residuals)
      gelu_chunk<true>(p.b1 + col0, v, bp, sp, warp, g, tq);
    else
      gelu_chunk<false>(p.b1 + col0, v, bp, sp, warp, g, tq);
    fence_async_shared();
    named_sync(1 + x.wg, 128);
    if (t == 0 && x.live && p.residuals) {
      tma_store(x.mf, buf, col0, x.m0);              // a
      tma_store(x.mf2, sbuf, col0, x.m0);            // s
      bulk_commit();
    }
  } else {
    // dh = da * s, float32, s from S's slot of this warpgroup
    mbar_wait(x.rs.full_bar(x.base), x.rs.phase);
    const unsigned char* sb =
        x.gbase + (x.rs.addr(x.base) + x.wg * kWgBoxBytes - x.base);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h, i = 4 * j + 2 * h;
        const unsigned sw =
            *reinterpret_cast<const unsigned*>(sb + swz(r, j) + 4 * tq);
        v[i] *= bf16_lo(sw);
        v[i + 1] *= bf16_hi(sw);
      }
    // every thread hands S's slot back, its loads of the slot done first: a
    // load still in flight when TMA refills the slot reads the next chunk's
    // s (the arrive does not wait for loads whose registers are not yet
    // used; seen on the card), so a proxy fence orders them before it
    fence_async_shared();
    mbar_arrive(x.rs.empty_bar(x.base));
    x.rs.next();
    if (p.dh_tap != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = x.m0 + 16 * warp + g + 8 * h, i = 4 * j + 2 * h;
          if (row < p.M)
            *reinterpret_cast<float2*>(p.dh_tap + (size_t)row * p.F + col0 +
                                       8 * j + 2 * tq) =
                make_float2(v[i], v[i + 1]);
        }
    }
    // the buffer is no longer read by the last chunk's store, whose column
    // sums are read
    if (t == 0) bulk_wait_read<0>();
    named_sync(1 + x.wg, 128);
    // db1's partial: a thread's two rows, the warp's eight row groups in a
    // butterfly, one warp's sums a row of wsum
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float cs = v[4 * j + e] + v[4 * j + 2 + e];
        cs += __shfl_xor_sync(0xffffffffu, cs, 4);
        cs += __shfl_xor_sync(0xffffffffu, cs, 8);
        cs += __shfl_xor_sync(0xffffffffu, cs, 16);
        if (g == 0) x.wsum()[warp * kMfChunk + 8 * j + 2 * tq + e] = cs;
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h, i = 4 * j + 2 * h;
        *reinterpret_cast<unsigned*>(bp + swz(r, j) + 4 * tq) =
            pack_bf16(v[i], v[i + 1]);
      }
    fence_async_shared();
    named_sync(1 + x.wg, 128);
    if (t == 0 && x.live) {
      tma_store(x.mf2, buf, col0, x.m0);             // dhc
      bulk_commit();
    }
    if (x.live && t < kMfChunk) {
      const float* w = x.wsum();
      x.cacc()[col0 + t] += ((w[t] + w[kMfChunk + t]) +
                               w[2 * kMfChunk + t]) + w[3 * kMfChunk + t];
    }
  }
  return buf;
}

// Chunk c of a tile, each product waited on as soon as it is issued: the
// two warpgroups of a block overlap each other's steps, and pipelining a
// warpgroup's own chunks (the next first product issued before this
// epilogue, the second waited on two chunks later) timed no faster on the
// card (tools/gemm_variants.py bf16-mlp).  first(c) into v, A's slot (and
// after the last chunk the x tile) handed back, the epilogue, second(c)
// added onto acc, B's slot handed back.
template <int C, bool BWD>
__device__ __forceinline__ void mf_chunk(MfCtx<C, BWD>& x, int c,
                                         float (&v)[32],
                                         float (&acc)[C / 2]) {
  mbar_wait(x.ra.full_bar(x.base), x.ra.phase);
  issue_first<C, BWD ? 1 : 0>(v, x.xw(), x.ra.addr(x.base));
  wgmma_wait0();
  fence_operands(v);
  if (x.lane() == 0) {
    mbar_arrive(x.ra.empty_bar(x.base));
    if (c == C / 16 - 1) mbar_arrive(x.xempty());
  }
  x.ra.next();
  const uint32_t buf = mf_epilogue<C, BWD>(x, c, v);
  mbar_wait(x.rb.full_bar(x.base), x.rb.phase);
  issue_second<C, BWD ? 1 : 0>(acc, buf, x.rb.addr(x.base));
  wgmma_wait0();
  fence_operands(acc);
  if (x.lane() == 0) mbar_arrive(x.rb.empty_bar(x.base));
  x.rb.next();
}

// The forward (BWD false) or the backward's row pass (BWD true) on tiles of
// 128 rows.  Maps: in, x or g (M, C); w1 (F, C); w2 (C, F); mf, a (stored)
// or s (loaded) (M, F); mf2, s (stored) or dhc (stored) (M, F).
template <int C, bool BWD>
__global__ void __launch_bounds__(kMfThreads, 1)
mlp_rows_bf16(const __grid_constant__ CUtensorMap t_in,
              const __grid_constant__ CUtensorMap t_w1,
              const __grid_constant__ CUtensorMap t_w2,
              const __grid_constant__ CUtensorMap t_mf,
              const __grid_constant__ CUtensorMap t_mf2,
              const __grid_constant__ MfArgs p) {
  using S = MfShape<C, BWD>;
  constexpr int NC = S::nc;
  extern __shared__ unsigned char mf_smem[];
  const uint32_t raw = smem_u32(mf_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = mf_smem + (base - raw);
  const uint32_t xs = base;                                 // x or g tiles
  const uint32_t xfull = base + S::xfull_off, xempty = base + S::xempty_off;
  typename MfRings<C, BWD>::A ra;
  typename MfRings<C, BWD>::Sr rs;
  typename MfRings<C, BWD>::B rb;
  const int wg = threadIdx.x / 128;
  const int tiles = (p.M + kMfRows - 1) / kMfRows;
  constexpr int chunks = C / 16;                            // F = 4C

  if (threadIdx.x == 0) {
    // a ring's mbarriers: "full" of each slot, then "empty" of each
    for (int s = 0; s < kMfMaxSlots; ++s) {
      if (s < ra.slots) {
        mbar_init(ra.full_bar(base) + 8 * s, 1);
        mbar_init(ra.empty_bar(base) + 8 * s, 8);
      }
      if (s < rs.slots) {   // every consumer thread hands S's slots back
        mbar_init(rs.full_bar(base) + 8 * s, 1);
        mbar_init(rs.empty_bar(base) + 8 * s, 256);
      }
      if (s < rb.slots) {
        mbar_init(rb.full_bar(base) + 8 * s, 1);
        mbar_init(rb.empty_bar(base) + 8 * s, 8);
      }
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(xfull + 8 * w, 1);
      mbar_init(xempty + 8 * w, 4);          // the warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_async_shared();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: one thread issues every box, chunk by chunk in the
    // order the consumers need them (A, S, B)
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 != 0) return;
    uint32_t xphase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile * kMfRows;
      // a warpgroup's rows wholly past M are not loaded (nor stored)
      const int live = m0 + 64 < p.M ? 2 : 1;
      for (int w = 0; w < live; ++w) {
        mbar_wait(xempty + 8 * w, xphase ^ 1);
        mbar_expect_tx(xfull + 8 * w, NC * kWgBoxBytes);
        for (int j = 0; j < NC; ++j)
          tma_load(xs + (w * NC + j) * kWgBoxBytes, &t_in, 64 * j,
                   m0 + 64 * w, xfull + 8 * w);
      }
      if (live == 1) {    // the idle warpgroup's tile still completes
        mbar_wait(xempty + 8, xphase ^ 1);
        mbar_arrive(xfull + 8);
      }
      xphase ^= 1;
      for (int ch = 0; ch < chunks; ++ch) {
        // w1's rows of the chunk (NC boxes along C) and w2's columns: A
        // and B forward, B and A backward
        for (int k = 0; k < 2; ++k) {
          // A and B have the same slot size: a ring's address, mbarrier
          // and phase by whichever is this one
          const uint32_t dst = k == 0 ? ra.addr(base) : rb.addr(base);
          const uint32_t full = k == 0 ? ra.full_bar(base) : rb.full_bar(base);
          mbar_wait(k == 0 ? ra.empty_bar(base) : rb.empty_bar(base),
                    (k == 0 ? ra.phase : rb.phase) ^ 1);
          mbar_expect_tx(full, S::a_bytes);
          const bool w1 = (k == 0) != BWD;
          for (int j = 0; j < NC; ++j) {
            if (w1)
              tma_load(dst + j * kWgBoxBytes, &t_w1, 64 * j, kMfChunk * ch,
                       full);
            else
              tma_load(dst + j * kWgBoxBytes, &t_w2, kMfChunk * ch, 64 * j,
                       full);
          }
          if (k == 0)
            ra.next();
          else
            rb.next();
          if (BWD && k == 0) {
            mbar_wait(rs.empty_bar(base), rs.phase ^ 1);
            mbar_expect_tx(rs.full_bar(base), live * kWgBoxBytes);
            for (int w = 0; w < live; ++w)
              tma_load(rs.addr(base) + w * kWgBoxBytes, &t_mf, kMfChunk * ch,
                       m0 + 64 * w, rs.full_bar(base));
            rs.next();
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of each tile
  setmaxnreg_inc<S::regs_consumer>();
  MfCtx<C, BWD> x;
  x.p = &p, x.mf = &t_mf, x.mf2 = &t_mf2, x.gbase = gbase, x.base = base;
  x.wg = wg, x.t = threadIdx.x % 128;
  const int t = x.t;
  if (BWD) {
    for (int i = t; i < S::acc_floats; i += 128) x.cacc()[i] = 0.f;
    named_sync(1 + wg, 128);
  }
  uint32_t xphase = 0;
  float v[32];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    x.m0 = tile * kMfRows + 64 * wg;               // this warpgroup's rows
    x.live = x.m0 < p.M;
    mbar_wait(xfull + 8 * wg, xphase);
    xphase ^= 1;
    if (BWD && x.live) {
      // db2: the g tile's columns over its 64 rows, in order, added to the
      // running sums
      for (int col = t; col < C; col += 128) {
        const unsigned char* box =
            gbase + (x.xw() - base) + (col / 64) * kWgBoxBytes;
        const int u = (col % 64) / 8, e = col % 8;
        float sum = 0.f;
#pragma unroll 8
        for (int r = 0; r < 64; ++r)
          sum += __bfloat162float(
              *reinterpret_cast<const bf16*>(box + swz(r, u) + 2 * e));
        x.cacc()[4 * C + col] += sum;
      }
    }
    float acc[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < chunks; ++c) mf_chunk<C, BWD>(x, c, v, acc);
    // o = acc + b2, or dx = acc, rounded once; rows past M masked
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int col = 8 * j + 2 * x.tq();
      float b0 = 0.f, b1 = 0.f;
      if (!BWD) {
        const unsigned bw = *reinterpret_cast<const unsigned*>(p.b2 + col);
        b0 = bf16_lo(bw), b1 = bf16_hi(bw);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = x.m0 + 16 * x.warp() + x.g() + 8 * h;
        const int i = 4 * j + 2 * h;
        if (row < p.M)
          *reinterpret_cast<unsigned*>(p.out + (size_t)row * C + col) =
              pack_bf16(acc[i] + b0, acc[i + 1] + b1);
      }
    }
  }
  if (BWD) {
    // the warpgroup's running sums, row 2 blockIdx + wg of the partials
    named_sync(1 + wg, 128);
    const size_t row = 2 * (size_t)blockIdx.x + wg;
    const float* sums_w = x.cacc();
    for (int i = t; i < 4 * C; i += 128) p.part1[row * 4 * C + i] = sums_w[i];
    for (int i = t; i < C; i += 128) p.part2[row * C + i] = sums_w[4 * C + i];
  }
  if (t == 0) bulk_wait_all();
}

// One launch of an instance on its maps (mlp.cu encodes them).
template <int C, bool BWD>
cudaError_t launch_mlp_rows(const CUtensorMap& in, const CUtensorMap& w1,
                            const CUtensorMap& w2, const CUtensorMap& mf,
                            const CUtensorMap& mf2, const MfArgs& args,
                            cudaStream_t stream) {
  using S = MfShape<C, BWD>;
  const auto kernel = mlp_rows_bf16<C, BWD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem);
  if (e != cudaSuccess) return e;
  const int tiles = (args.M + kMfRows - 1) / kMfRows;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kernel<<<grid, kMfThreads, S::smem, stream>>>(in, w1, w2, mf, mf2, args);
  static const std::string name = template_name("mlp_rows_bf16", C, BWD);
  count_launch(name.c_str());
  return cudaGetLastError();
}

// The instance for width c (mlp_fused(c, f) must hold).
template <bool BWD>
cudaError_t launch_mlp_rows_c(int c, const CUtensorMap& in,
                              const CUtensorMap& w1, const CUtensorMap& w2,
                              const CUtensorMap& mf, const CUtensorMap& mf2,
                              const MfArgs& args, cudaStream_t stream) {
  switch (c) {
    case 48:
      return launch_mlp_rows<48, BWD>(in, w1, w2, mf, mf2, args, stream);
    case 96:
      return launch_mlp_rows<96, BWD>(in, w1, w2, mf, mf2, args, stream);
    case 192:
      return launch_mlp_rows<192, BWD>(in, w1, w2, mf, mf2, args, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// An instance's rings' slots (A, S, B) and dynamic shared memory in bytes,
// as vitta_mlp_bf16_rows_plan reports them.
template <int C, bool BWD>
inline void mlp_rows_shape_of(int* out) {
  using S = MfShape<C, BWD>;
  out[0] = S::slots_a, out[1] = S::slots_s, out[2] = S::slots_b;
  out[3] = S::smem;
}
template <bool BWD>
inline void mlp_rows_shape(int c, int* out) {
  switch (c) {
    case 48:
      return mlp_rows_shape_of<48, BWD>(out);
    case 96:
      return mlp_rows_shape_of<96, BWD>(out);
    default:
      return mlp_rows_shape_of<192, BWD>(out);
  }
}

}  // namespace vitta
