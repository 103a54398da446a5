// The port's bfloat16 matrix product for Hopper (sm_90a), on wgmma fed by
// TMA: the six products of the bfloat16 MLP, with the LayerNorm in front
// and without (mlp.cu; vitta_tpu's _lnmlp_fwd_kernel, _lnmlp_bwd_kernel,
// _fwd_kernel and _bwd_kernel at the compute dtype,
// vitta_tpu/ops/pallas_mlp.py:138-183, :303-369).
//
// It also runs the six products of the bfloat16 projection-fused window
// attention (attention_proj.cu; _proj_fwd_kernel, _proj_bwd_kernel and
// their LayerNorm forms at the compute dtype, vitta_tpu/ops/
// pallas_attention.py:724-782, :945-1016), which have the MLP's operand
// layouts: qkv = y wqkv^T and out = o_att wproj^T as h and o (EPI_DENSE),
// g_att = g wproj and dx = dqkv wqkv (dy + gy under the LayerNorm) as dh
// and dy, dwproj = g^T o_att and dwqkv = dqkv^T y as dw2 and dw1.
//
// gemm_wgmma_bf16 computes C (M, N) = sum over k of a[m][k] b[n][k] for
// row-major bfloat16 operands, each either K-major (the contraction index
// contiguous: an activation (M, K) as A, an nn.Linear weight (N, K) as B)
// or MN-major (the contraction index the row: a weight (K, N) as B, and
// both operands of a weight gradient, which contracts over the activation's
// rows).  The six products and their layouts:
//   h   = y w1^T     A K-major   B K-major    (GELU epilogue: a and s)
//   o   = a w2^T     A K-major   B K-major    (+ b2)
//   dh  = go w2      A K-major   B MN-major   (* s: dh float32 and dhc)
//   dy  = dhc w1     A K-major   B MN-major   (+ gy, float32; without the
//                                              LayerNorm dx, bfloat16)
//   dw1 = dhc^T y    A MN-major  B MN-major   (float32 partials)
//   dw2 = go^T a     A MN-major  B MN-major   (float32 partials)
// Every layout is a shared-memory descriptor of wgmma (its transpose bits);
// nothing is transposed in device memory.
//
// What bounds it: operations, 2MNK of them against (MK + NK + MN) values,
// at 989 TFLOP/s of dense bfloat16 on the H100, which only wgmma reaches
// (one mma.sync a fragment ran these products at about 105 on an H100).
// The design:
// * Loads.  Each operand is one TMA tensor map of 64 x 64 boxes with the
//   128-byte swizzle (make_map; encoded on the host through the driver
//   entry point, one map per operand tensor of a call, passed as a
//   __grid_constant__ parameter).  A slice is 64 k deep: one box per 64
//   rows of a K-major tile (64 rows of 128 bytes), one per 64 columns of an
//   MN-major tile (64 k rows of 128 bytes).  The ring holds kStages slices;
//   one producer thread issues the boxes of a slice on the slot's "full"
//   mbarrier (with its byte count), the consumers hand the slot back on
//   its "empty" one.  Boxes past the ragged M or N edge are zero-filled by
//   TMA, or skipped where they lie wholly outside (their products land in
//   rows or columns the epilogue does not store); a K that is no multiple
//   of 64 is zero-filled in its last slice.
// * Products.  One consumer warpgroup per 64 rows of the tile issues
//   wgmma.m64n128k16 (float32 accumulators, bfloat16 operands from shared
//   memory; A's descriptor advances 32 bytes a k16 step where it is
//   K-major, 2048 where it is MN-major).  setmaxnreg gives the producer
//   warpgroup 40 registers a thread and the consumers the rest.
// * Promotion.  The tensor cores add into their accumulator with
//   truncation (gemm_tiles.cuh: summed in place over K = 4096 that bias
//   broke MLP_BWD_TOL).  So each 64-deep slice goes into fresh
//   accumulators (its first wgmma with scale-d 0), which are then added to
//   the running float32 sums with a float add.  Two fresh sets take turns,
//   so that the next slice's wgmma run while this one's are added: three
//   accumulator sets of 64 x 128 a warpgroup, 192 registers a thread.
//   VITTA_WG_PROMOTE=0 (the variants tool only) sums in place; it misses
//   the tolerance at K = 2048 and 4096 on an H100.
// * Epilogue.  A warpgroup's tile goes from registers into shared memory
//   (float32 rows of 136, conflict-free float2 stores), then each thread
//   takes 8 neighbouring columns of 8 rows, every load first: bias, GELU
//   (erff, and __expf for the derivative's phi: gelu_parts_bf16), the
//   product with s or the sum with gy, every global load and store 16
//   bytes, the rows past M masked; dh's product also sums its columns per
//   64 rows (db1's partials).  Each value is rounded once, where the
//   Pallas kernels round it, but under EPI_DENSE: flax's Dense at the
//   compute dtype, as the projection-fused kernels apply it
//   (pallas_attention.py:732, :737, :955, :960), rounds the product to
//   bfloat16, adds the bfloat16 bias and rounds the sum again; adding the
//   bias to the float32 sum first (EPI_BIAS, right for the MLP,
//   pallas_mlp.py:315-316) lands one ulp off wherever the two roundings
//   differ.
// * Filling the card.  The kernel is persistent: min(work, blocks a SM x
//   SMs) blocks walk the tiles (and chunks of K) in order, the producer
//   running ahead into the next tile's slices while the consumers store.
//   wg_row_plan picks, per product, 128 x 128 tiles (two consumer
//   warpgroups, one block an SM, kStages128 slots) or 64 x 128 tiles (one
//   consumer warpgroup, two blocks an SM, kStages64 slots each) by the
//   time each would take on the card's SMs.  The two weight gradients (K = all M
//   rows, outputs of few tiles) run in one launch (wgmma_grads), K cut
//   into as many chunks as let their tiles together fill the SMs once: a
//   gradient left in one chunk is rounded in its epilogue, one in chunks
//   writes float32 partials that reduce_partials (reduce.cuh) adds in
//   chunk order and rounds once: no atomics, the same bits every run.
//
// Every extent but M must be a multiple of 8 and every pointer 16-byte
// aligned (TMA's strides and the epilogue's 16-byte moves); mlp.cu checks
// both.  A K that is no multiple of 64 (Swin-T's C = 96: 1.5 slices) and
// an N that is none of the 128-wide tile (96, 192) take TMA's zeros in
// their last slice or box, and the epilogue stores no column past N.  vitta_tpu_torch/tools/gemm_variants.py builds mlp.cu with other
// VITTA_WG_STAGES_128 / _64, VITTA_WG_PROMOTE, VITTA_WG_TILE (64, 128 or 256
// for every row product; 256, a 128 x 256 tile of two n128 products a
// warpgroup, only without promotion: its two accumulator sets would need
// 256 registers), VITTA_WG_ROW_SPLIT (the row products cut into that many
// chunks of K, their partials added by a finishing launch),
// VITTA_WG_GRAD_TILE (64: the weight gradients' tiles at 64 rows) and
// VITTA_WG_EXPF (1: expf for the GELU derivative's phi) and times them.

#pragma once
#include <cuda.h>   // CUtensorMap; the encoder comes from the runtime
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16.cuh"
#include "gemm_tiles.cuh"
#include "launches.cuh"
#include "reduce.cuh"

#ifndef VITTA_WG_STAGES_128
#define VITTA_WG_STAGES_128 4
#endif
#ifndef VITTA_WG_STAGES_64
#define VITTA_WG_STAGES_64 3
#endif
#ifndef VITTA_WG_PROMOTE
#define VITTA_WG_PROMOTE 1
#endif
#ifndef VITTA_WG_TILE
#define VITTA_WG_TILE 0
#endif
#ifndef VITTA_WG_ROW_SPLIT
#define VITTA_WG_ROW_SPLIT 1
#endif
#ifndef VITTA_WG_EXPF
#define VITTA_WG_EXPF 0
#endif
#ifndef VITTA_WG_GRAD_TILE
#define VITTA_WG_GRAD_TILE 128
#endif

namespace vitta {

constexpr int kWgBK = 64;                     // k depth of a slice
constexpr int kWgBoxBytes = 64 * 64 * 2;      // one 64 x 64 bfloat16 box
constexpr int kWgStageLd = 136;               // floats a staged row
constexpr int kStages128 = VITTA_WG_STAGES_128;
constexpr int kStages64 = VITTA_WG_STAGES_64;
constexpr bool kWgPromote = VITTA_WG_PROMOTE != 0;
constexpr int kWgTile = VITTA_WG_TILE;
constexpr int kWgRowSplit = VITTA_WG_ROW_SPLIT;
constexpr int kWgGradTile = VITTA_WG_GRAD_TILE;
static_assert(kWgGradTile == 64 || kWgGradTile == 128, "grad tile 64 or 128");
static_assert(kWgTile == 0 || kWgTile == 64 || kWgTile == 128 ||
                  (kWgTile == 256 && !kWgPromote),
              "tile 64, 128, or 256 without promotion");
static_assert(kWgRowSplit >= 1, "at least one chunk");
// The Dense epilogue of the bfloat16 core only: C = bfloat16(bfloat16(acc)
// + bias[col]), the product rounded before the bias is added.
constexpr int EPI_DENSE = 6;
static_assert(EPI_DENSE != EPI_BIAS && EPI_DENSE != EPI_GELU &&
                  EPI_DENSE != EPI_MUL && EPI_DENSE != EPI_ADD &&
                  EPI_DENSE != EPI_RAW && EPI_DENSE != EPI_PART,
              "an epilogue of its own");
// a wait on an mbarrier longer than this (some 8 s) traps: a fault that
// would leave a slot unfilled ends the launch with an error, not a hang
constexpr long long kWgWaitCycles = 1LL << 34;

// Where a bfloat16 product's epilogue writes: float32 (f), bfloat16 (b),
// both, and under EPI_GELU the derivative (s, bfloat16); null: not wanted.
// EPI_RAW writes chunk z at f + z * M * N, or b where K is one chunk.
struct Bf16Out {
  float* f;
  bf16* b;
  bf16* s;
};

// What a launch of gemm_wgmma_bf16 computes: C (M, N) over K in chunks of
// kchunk (a multiple of kWgBK; one chunk but in a weight gradient), its
// work items z-major over the m_tiles x n_tiles tiles.
// colsum (EPI_MUL only, or null): the column sums of C, one row of N
// floats per 64 rows of C (colsum_partials: cdiv(M, 64) rows), each over
// its rows in a fixed order, for a bias gradient that reduce_partials
// then adds in row-block order.
struct WgArgs {
  const bf16* bias;
  const bf16* aux;
  Bf16Out out;
  float* colsum;
  int M, N, K, kchunk, m_tiles, n_tiles, work;
};

// Rows of the column-sum partials of a product with M rows.
inline long long colsum_partials(long long M) { return (M + 63) / 64; }

template <int BM, int BN, int STAGES>
struct WgShape {
  static constexpr int consumers = BM / 64;          // warpgroups
  static constexpr int threads = 128 * (consumers + 1);
  static constexpr int blocks = BM == 64 ? 2 : 1;    // a SM
  static constexpr int a_bytes = BM / 64 * kWgBoxBytes;
  static constexpr int b_bytes = BN / 64 * kWgBoxBytes;
  static constexpr int stage_bytes = a_bytes + b_bytes;
  static constexpr int staging_bytes = consumers * 64 * kWgStageLd * 4;
  // 1024 of slack to align the ring to the swizzle's 1024-byte atoms
  static constexpr int smem =
      1024 + STAGES * stage_bytes + staging_bytes + 2 * STAGES * 8;
  // registers a thread after setmaxnreg: the block's whole share
  // (65536 / blocks) split 40 to the producer, the rest to the consumers
  static constexpr int regs_producer = 40;
  static constexpr int regs_consumer =
      ((65536 / blocks / threads / 8 * 8) * (consumers + 1) - 40) /
      consumers / 8 * 8;
  static_assert(smem <= 232448, "shared memory of a block");
};

// ------------------------------------------------ device-side primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0)
      t0 = clock64();
    else if (clock64() - t0 > kWgWaitCycles)
      __trap();
  }
}

// One box (c0 the inner, contiguous coordinate, c1 the row) of a tensor map
// into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The wgmma descriptor of a 128-byte-swizzled operand at shared address
// `addr` (inside a 1024-byte-aligned atom grid): lbo, the byte offset
// between 64-wide MN blocks (MN-major; unused K-major), sbo between groups
// of 8 rows (K-major) or 8 k (MN-major).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// k16 step kk of a slice: a K-major operand (rows of 128 bytes, 8-row
// atoms of 1024) moves 32 bytes along its rows; an MN-major one (k rows of
// 128 bytes in 64-wide boxes of 8192) moves 16 k rows.
template <bool MN>
__device__ __forceinline__ uint64_t wg_operand(uint32_t addr, int kk) {
  return MN ? wg_desc(addr + kk * 2048, kWgBoxBytes, 1024)
            : wg_desc(addr + kk * 32, 16, 1024);
}

// d (64 x 128, this warpgroup's float32 fragment) = A (64 x 16) B (16 x 128)
// (+ d where acc is not 0), A and B from shared memory through their
// descriptors; TA / TB 1 where the operand is MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// 8 bfloat16 values of a 16-byte word added to or multiplied into v.
__device__ __forceinline__ void add8(float (&v)[8], uint4 w) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[2 * i] += bf16_lo(u[i]), v[2 * i + 1] += bf16_hi(u[i]);
}
__device__ __forceinline__ void mul8(float (&v)[8], uint4 w) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[2 * i] *= bf16_lo(u[i]), v[2 * i + 1] *= bf16_hi(u[i]);
}
// v rounded to the nearest bfloat16, even on a tie, as float32.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store_bf16x8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void store_f32x8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// gelu_parts with the fast exponential (__expf) for phi in s: its error,
// under 1e-7 of s's magnitude at most (h phi(h) <= 0.25, and the large
// relative error of __expf falls where phi is tiny), is far below the
// bfloat16 ulp s is rounded to; erff keeps Phi exact to float32.
__device__ __forceinline__ void gelu_parts_bf16(float h, float& a,
                                                float& s) {
  const float phi = 0.5f * (1.0f + erff(h * 0.7071067811865476f));
  a = h * phi;
#if VITTA_WG_EXPF
  s = phi + h * expf(-0.5f * h * h) * 0.3989422804014327f;
#else
  s = phi + h * __expf(-0.5f * h * h) * 0.3989422804014327f;
#endif
}

// The bias word (8 bfloat16 values at col) an epilogue reads, or zeros.
template <int EPI>
__device__ __forceinline__ uint4 wg_bias(const WgArgs& p, int col) {
  if (EPI == EPI_BIAS || EPI == EPI_GELU || EPI == EPI_DENSE)
    return *reinterpret_cast<const uint4*>(p.bias + col);
  return make_uint4(0u, 0u, 0u, 0u);
}

// The aux word (8 bfloat16 values of C's shape at `at`) an epilogue reads,
// or zeros where it reads none or `ok` is false (a row past M).
template <int EPI>
__device__ __forceinline__ uint4 wg_aux(const WgArgs& p, size_t at, bool ok) {
  if ((EPI == EPI_MUL || (EPI == EPI_ADD && p.aux != nullptr)) && ok)
    return *reinterpret_cast<const uint4*>(p.aux + at);
  return make_uint4(0u, 0u, 0u, 0u);
}

// The epilogue on the float32 sums v of C[row][col .. col + 7] (at = row *
// N + col; col a multiple of 8, so that the 8 lie inside N or outside it
// together), with the bias word bw and the aux word xw already loaded:
// EPI_BIAS and EPI_GELU add the bias, EPI_GELU writes gelu and its
// derivative, EPI_MUL multiplies by aux, EPI_ADD adds aux where it is not
// null, EPI_RAW writes chunk z's partial (or, a product in one chunk, its
// rounded value); each value rounded once, but under EPI_DENSE, which
// rounds the sum, adds the bias and rounds again.  Stores only where
// `ok`.
template <int EPI>
__device__ __forceinline__ void wg_epilogue(const WgArgs& p, float (&v)[8],
                                            uint4 bw, uint4 xw, size_t at,
                                            int z, bool ok) {
  if (EPI == EPI_BIAS || EPI == EPI_GELU) add8(v, bw);
  if (EPI == EPI_DENSE) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = round_bf16(v[e]);
    add8(v, bw);
  }
  if (EPI == EPI_GELU) {
    float s[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) gelu_parts_bf16(v[e], v[e], s[e]);
    if (ok && p.out.s != nullptr) store_bf16x8(p.out.s + at, s);
  }
  if (EPI == EPI_MUL) mul8(v, xw);
  if (EPI == EPI_ADD && p.aux != nullptr) add8(v, xw);
  if (!ok) return;
  float* f = p.out.f;
  if (EPI == EPI_RAW) f += (size_t)z * p.M * p.N;
  if (f != nullptr) store_f32x8(f + at, v);
  if (p.out.b != nullptr) store_bf16x8(p.out.b + at, v);
}

// Work item w: chunk z of K, tile (mb, nb).
struct WgItem {
  int m0, n0, z, kbeg, nk;
};

template <int BM, int BN>
__device__ __forceinline__ WgItem wg_item(const WgArgs& p, int w) {
  const int tiles = p.m_tiles * p.n_tiles;
  WgItem it;
  it.z = w / tiles;
  const int r = w - it.z * tiles;
  it.m0 = r / p.n_tiles * BM;
  it.n0 = (r % p.n_tiles) * BN;
  it.kbeg = it.z * p.kchunk;
  const int kend = min(p.K, it.kbeg + p.kchunk);
  it.nk = (kend - it.kbeg + kWgBK - 1) / kWgBK;
  return it;
}

template <int BM, int BN, int STAGES, bool PROMOTE, bool A_MN, bool B_MN,
          int EPI>
__global__ void __launch_bounds__(WgShape<BM, BN, STAGES>::threads,
                                  WgShape<BM, BN, STAGES>::blocks)
gemm_wgmma_bf16(const __grid_constant__ CUtensorMap tmA,
                const __grid_constant__ CUtensorMap tmB,
                const __grid_constant__ CUtensorMap tmA2,
                const __grid_constant__ CUtensorMap tmB2,
                const __grid_constant__ WgArgs p,
                const __grid_constant__ WgArgs p2) {
  using S = WgShape<BM, BN, STAGES>;
  constexpr int NB = BN / 128;   // n128 products a warpgroup, a k16 step
  static_assert(BN == 128 || BN == 256, "n128 products");
  static_assert(!PROMOTE || NB == 1, "two accumulator sets of 64 x 128");
  extern __shared__ unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t ring = (raw + 1023) & ~1023u;
  float* staging = reinterpret_cast<float*>(wg_smem + (ring - raw) +
                                            STAGES * S::stage_bytes);
  const uint32_t full = ring + STAGES * S::stage_bytes + S::staging_bytes;
  const uint32_t empty = full + STAGES * 8;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * S::consumers);   // a warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (wg == S::consumers) {
    // the producer: one thread issues every slice's boxes
    setmaxnreg_dec<S::regs_producer>();
    if (threadIdx.x % 128 != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int w = blockIdx.x; w < p.work + p2.work; w += gridDim.x) {
      const bool two = w >= p.work;
      const WgArgs& q = two ? p2 : p;
      const CUtensorMap* mapA = two ? &tmA2 : &tmA;
      const CUtensorMap* mapB = two ? &tmB2 : &tmB;
      const WgItem it = wg_item<BM, BN>(q, two ? w - p.work : w);
      const int na = min(BM / 64, (q.M - it.m0 + 63) / 64);
      const int nb = min(BN / 64, (q.N - it.n0 + 63) / 64);
      for (int s = 0; s < it.nk; ++s) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t bar = full + 8 * stage;
        const uint32_t a = ring + stage * S::stage_bytes;
        const uint32_t b = a + S::a_bytes;
        const int k0 = it.kbeg + s * kWgBK;
        mbar_expect_tx(bar, (uint32_t)(na + nb) * kWgBoxBytes);
        for (int j = 0; j < na; ++j) {
          if (A_MN)
            tma_load(a + j * kWgBoxBytes, mapA, it.m0 + 64 * j, k0, bar);
          else
            tma_load(a + j * kWgBoxBytes, mapA, k0, it.m0 + 64 * j, bar);
        }
        for (int j = 0; j < nb; ++j) {
          if (B_MN)
            tma_load(b + j * kWgBoxBytes, mapB, it.n0 + 64 * j, k0, bar);
          else
            tma_load(b + j * kWgBoxBytes, mapB, k0, it.n0 + 64 * j, bar);
        }
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg * 64 .. wg * 64 + 63 of each tile
  setmaxnreg_inc<S::regs_consumer>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;      // the fragment's row and pair
  float* stg = staging + wg * 64 * kWgStageLd;
  int stage = 0;
  uint32_t phase = 0;
  for (int w = blockIdx.x; w < p.work + p2.work; w += gridDim.x) {
    const bool two = w >= p.work;
    const WgArgs& q = two ? p2 : p;
    const WgItem it = wg_item<BM, BN>(q, two ? w - p.work : w);
    float acc[NB][64];
    // a slot's shared address; the next slot, once its slice has landed
    auto slot = [&](int sl) { return ring + sl * S::stage_bytes; };
    auto next_slot = [&]() {
      const int sl = stage;
      mbar_wait(full + 8 * sl, phase);
      if (++stage == STAGES) stage = 0, phase ^= 1;
      return sl;
    };
    if constexpr (PROMOTE) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = 0.f;
      // each slice into fresh sums, the next slice's wgmma issued before
      // this one's are added to the running sums (two fresh sets, d0 and
      // d1, in turns)
      float d0[64], d1[64];
      auto issue = [&](float (&d)[64], int sl) {
        const uint32_t a = slot(sl) + wg * kWgBoxBytes;
        const uint32_t b = slot(sl) + S::a_bytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk)
          wgmma_m64n128<A_MN, B_MN>(d, wg_operand<A_MN>(a, kk),
                                    wg_operand<B_MN>(b, kk), kk);
        wgmma_commit();
      };
      auto retire = [&](float (&d)[64], int sl) {
        fence_operands(d);
        if (lane == 0) mbar_arrive(empty + 8 * sl);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[0][i] += d[i];
      };
      int cur = next_slot();
      issue(d0, cur);
      for (int s = 0; s < it.nk; s += 2) {
        int nxt = -1;
        if (s + 1 < it.nk) {
          nxt = next_slot();
          issue(d1, nxt);
          wgmma_wait1();
        } else {
          wgmma_wait0();
        }
        retire(d0, cur);
        if (nxt < 0) break;
        cur = nxt, nxt = -1;
        if (s + 2 < it.nk) {
          nxt = next_slot();
          issue(d0, nxt);
          wgmma_wait1();
        } else {
          wgmma_wait0();
        }
        retire(d1, cur);
        if (nxt < 0) break;
        cur = nxt;
      }
    } else {
      // in place: each slice's wgmma issued before the last one's slot is
      // handed back
      int prev = -1;
      for (int s = 0; s < it.nk; ++s) {
        const int sl = next_slot();
        const uint32_t a = slot(sl) + wg * kWgBoxBytes;
        const uint32_t b = slot(sl) + S::a_bytes;
#pragma unroll
        for (int n = 0; n < NB; ++n) fence_operands(acc[n]);
        wgmma_fence();
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int kk = 0; kk < kWgBK / 16; ++kk)
            wgmma_m64n128<A_MN, B_MN>(
                acc[n], wg_operand<A_MN>(a, kk),
                wg_operand<B_MN>(b + n * 2 * kWgBoxBytes, kk),
                s > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait1();
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = sl;
      }
      wgmma_wait0();
#pragma unroll
      for (int n = 0; n < NB; ++n) fence_operands(acc[n]);
      if (lane == 0) mbar_arrive(empty + 8 * prev);
    }

    // the epilogue, 128 columns at a time: the fragment into shared
    // memory, then a thread takes 8 neighbouring columns (the same for all
    // its rows) of 8 rows, every load before the math
    const int rows0 = it.m0 + wg * 64;           // this warpgroup's rows
    const int row0 = rows0 + t / 16, c = (t % 16) * 8;
    const bool sums = EPI == EPI_MUL && q.colsum != nullptr;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      named_sync(1 + wg, 128);          // the last tile's reads are done
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              stg + (16 * warp + g + 8 * h) * kWgStageLd + 8 * j + 2 * tq) =
              make_float2(acc[n][4 * j + 2 * h], acc[n][4 * j + 2 * h + 1]);
      named_sync(1 + wg, 128);
      const int col = it.n0 + n * 128 + c;
      const bool col_ok = col < q.N;
      float cs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (col_ok) {
        const uint4 bw = wg_bias<EPI>(q, col);
        uint4 xw[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = row0 + 8 * i;
          xw[i] = wg_aux<EPI>(q, (size_t)row * q.N + col, row < q.M);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = row0 + 8 * i;
          const float* sv = stg + (t / 16 + 8 * i) * kWgStageLd + c;
          const float4 lo = *reinterpret_cast<const float4*>(sv);
          const float4 hi = *reinterpret_cast<const float4*>(sv + 4);
          float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
          wg_epilogue<EPI>(q, v, bw, xw[i], (size_t)row * q.N + col, it.z,
                           row < q.M);
          if (sums && row < q.M) {
#pragma unroll
            for (int e = 0; e < 8; ++e) cs[e] += v[e];
          }
        }
      }
      if (sums) {
        // the warpgroup's column sums over its 64 rows: each thread's 8
        // rows (t / 16 + 8 i, i in order), then its 8 groups of rows in
        // order, one thread a column
        named_sync(1 + wg, 128);        // every staged row is read
#pragma unroll
        for (int e = 0; e < 8; ++e) stg[(t / 16) * kWgStageLd + c + e] = cs[e];
        named_sync(1 + wg, 128);
        const int sc = it.n0 + n * 128 + t;
        if (rows0 < q.M && sc < q.N) {
          float total = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) total += stg[k * kWgStageLd + t];
          q.colsum[(size_t)(rows0 / 64) * q.N + sc] = total;
        }
      }
    }
  }
}

// The sum of a row product's chunk partials in chunk order, through the
// product's epilogue (VITTA_WG_ROW_SPLIT > 1): 8 columns a thread.
template <int EPI>
__global__ void __launch_bounds__(256)
wg_split_finish(const float* __restrict__ partial, int splits, WgArgs p) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 8;
  if (i >= (long long)p.M * p.N) return;
  const int row = (int)(i / p.N), col = (int)(i % p.N);
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int z = 0; z < splits; ++z) {
    const float* q = partial + (size_t)z * p.M * p.N + i;
    const float4 lo = reinterpret_cast<const float4*>(q)[0];
    const float4 hi = reinterpret_cast<const float4*>(q)[1];
    v[0] += lo.x, v[1] += lo.y, v[2] += lo.z, v[3] += lo.w;
    v[4] += hi.x, v[5] += hi.y, v[6] += hi.z, v[7] += hi.w;
  }
  const size_t at = (size_t)row * p.N + col;
  wg_epilogue<EPI>(p, v, wg_bias<EPI>(p, col), wg_aux<EPI>(p, at, true), at,
                   0, true);
}

// ------------------------------------------------------------- host side

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the
// libraries link no -lcuda); null where the driver has none.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major bfloat16 matrix (rows, cols) in 64 x 64
// boxes with the 128-byte swizzle, zeros outside it.  cols must be a
// multiple of 8 and p 16-byte aligned.  false where the encoder refuses.
inline bool make_map(CUtensorMap* map, const bf16* p, long long rows,
                     long long cols) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<bf16*>(p), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// How one product is cut: the tile (bm x bn), the chunks of K and their
// length, the work items and the persistent grid.
struct WgPlan {
  int bm, bn, splits, kchunk, work, grid;
};

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

inline WgPlan wg_finish(WgPlan p, int M, int N, int K, int sms) {
  p.kchunk = (int)(cdiv(cdiv(K, p.splits), kWgBK) * kWgBK);
  p.splits = (int)cdiv(K, p.kchunk);
  p.work = (int)(cdiv(M, p.bm) * cdiv(N, p.bn) * p.splits);
  const int slots = (p.bm == 64 ? 2 : 1) * sms;
  p.grid = p.work < slots ? p.work : slots;
  return p;
}

// A row product (M, N) of depth K (an activation times a weight): 64 x 128
// tiles where they take less time than 128 x 128 ones, at a 64-row tile's
// half the work in one SM-wave of either (cdiv(t64, sms) / 2 against
// cdiv(t128, sms)), and where the two tie at fewer than two waves of
// 128-row tiles (measured on an H100: Swin-B's stage-3 o and dy 5-18%
// faster at 64 rows, stage 2's h 8% slower; tools/gemm_variants.py); no
// chunks of K (VITTA_WG_ROW_SPLIT in the variants).
inline WgPlan wg_row_plan(int M, int N, int K, int sms) {
  WgPlan p;
  const long long t128 = cdiv(M, 128) * cdiv(N, 128);
  const long long t64 = cdiv(M, 64) * cdiv(N, 128);
  const long long w64 = cdiv(t64, sms), w128 = 2 * cdiv(t128, sms);
  p.bm = w64 < w128 || (w64 == w128 && t128 < 2LL * sms) ? 64 : 128;
  p.bn = 128;
  if (kWgTile == 64 || kWgTile == 128) p.bm = kWgTile;
  if (kWgTile == 256) p.bm = 128, p.bn = 256;
  p.splits = kWgRowSplit;
  return wg_finish(p, M, N, K, sms);
}

// A weight gradient (M, N) = A^T B over K rows that shares its launch
// with others of `tiles_all` tiles in all (its own included): 128 x 128
// tiles (VITTA_WG_GRAD_TILE=64 in the variants: 64 x 128, two blocks a
// SM), and as many chunks of K as let the launch's tiles fill the SMs'
// blocks once (at most one a 512 rows; none where the tiles fill them).
inline long long wg_grad_tiles(int M, int N) {
  return cdiv(M, kWgGradTile) * cdiv(N, 128);
}

inline WgPlan wg_grad_plan(int M, int N, int K, long long tiles_all,
                           int sms) {
  WgPlan p;
  p.bm = kWgGradTile, p.bn = 128;
  long long splits = (p.bm == 64 ? 2 : 1) * sms / tiles_all;
  const long long most = K / 512;
  splits = splits < 1 ? 1 : splits;
  splits = splits > most ? (most < 1 ? 1 : most) : splits;
  p.splits = (int)splits;
  return wg_finish(p, M, N, K, sms);
}

template <int BM, int BN, int STAGES, bool PROMOTE, bool A_MN, bool B_MN,
          int EPI>
cudaError_t launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb,
                         const WgArgs& args, int grid, cudaStream_t stream,
                         const CUtensorMap* ta2 = nullptr,
                         const CUtensorMap* tb2 = nullptr,
                         const WgArgs* args2 = nullptr) {
  using S = WgShape<BM, BN, STAGES>;
  const auto kernel =
      gemm_wgmma_bf16<BM, BN, STAGES, PROMOTE, A_MN, B_MN, EPI>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem);
  if (e != cudaSuccess) return e;
  WgArgs none = args;
  none.work = 0;
  kernel<<<grid, S::threads, S::smem, stream>>>(
      ta, tb, ta2 ? *ta2 : ta, tb2 ? *tb2 : tb, args, args2 ? *args2 : none);
  static const std::string name = template_name(
      "gemm_wgmma_bf16", BM, BN, STAGES, PROMOTE, A_MN, B_MN, EPI);
  count_launch(name.c_str());
  return cudaGetLastError();
}

// The instance of gemm_wgmma_bf16 a row product's plan asks for.
template <bool A_MN, bool B_MN, int EPI>
cudaError_t launch_by_plan(const CUtensorMap& ta, const CUtensorMap& tb,
                           const WgArgs& args, const WgPlan& plan,
                           cudaStream_t stream) {
  static_assert(!A_MN, "a row product: A is K-major");
  if constexpr (kWgTile == 256) {
    return launch_wgmma<128, 256, 3, false, A_MN, B_MN, EPI>(
        ta, tb, args, plan.grid, stream);
  } else {
    if (plan.bm == 64)
      return launch_wgmma<64, 128, kStages64, kWgPromote, A_MN, B_MN, EPI>(
          ta, tb, args, plan.grid, stream);
    return launch_wgmma<128, 128, kStages128, kWgPromote, A_MN, B_MN, EPI>(
        ta, tb, args, plan.grid, stream);
  }
}

// One row product by its plan: C (M, N) over K with A and B behind their
// maps.  Where the plan cuts K into chunks (VITTA_WG_ROW_SPLIT), EPI_RAW
// writes them to `partial` and the epilogue runs on their ordered sum in
// wg_split_finish, its output as `out` says.
template <bool A_MN, bool B_MN, int EPI>
cudaError_t wgmma_product(const CUtensorMap& ta, const CUtensorMap& tb,
                          const bf16* bias, const bf16* aux,
                          const Bf16Out& out, float* partial, int M, int N,
                          int K, const WgPlan& plan, cudaStream_t stream,
                          float* colsum = nullptr) {
  static_assert(EPI != EPI_RAW, "a weight gradient: wgmma_grads");
  const bool split = plan.splits > 1;
  WgArgs args{bias,    aux,         out,
              colsum,  M,           N,
              K,       plan.kchunk, (int)cdiv(M, plan.bm),
              (int)cdiv(N, plan.bn), plan.work};
  if (split) args.out = Bf16Out{partial, nullptr, nullptr};
  if constexpr (kWgRowSplit > 1) {
    if (split) {
      const cudaError_t e =
          launch_by_plan<A_MN, B_MN, EPI_RAW>(ta, tb, args, plan, stream);
      if (e != cudaSuccess) return e;
      args.out = out;
      const long long chunks = (long long)M * N / 8;
      wg_split_finish<EPI><<<(unsigned)cdiv(chunks, 256), 256, 0, stream>>>(
          partial, plan.splits, args);
      count_launch("wg_split_finish");
      return cudaGetLastError();
    }
  }
  return launch_by_plan<A_MN, B_MN, EPI>(ta, tb, args, plan, stream);
}

// A weight gradient for wgmma_grads: its operands' maps, its extents and
// plan, and where it goes: `out`, rounded in the epilogue, where the plan
// leaves K in one chunk; else its chunks' float32 partials at `partial`,
// which the caller adds in chunk order (reduce_partials).
struct WgGrad {
  const CUtensorMap* ta;
  const CUtensorMap* tb;
  int M, N, K;
  WgPlan plan;
  bf16* out;
  float* partial;
};

inline WgArgs wg_grad_args(const WgGrad& g) {
  WgArgs a{nullptr, nullptr, Bf16Out{nullptr, g.out, nullptr}, nullptr,
           g.M, g.N, g.K, g.plan.kchunk, (int)cdiv(g.M, g.plan.bm),
           (int)cdiv(g.N, g.plan.bn), g.plan.work};
  if (g.plan.splits > 1) a.out = Bf16Out{g.partial, nullptr, nullptr};
  return a;
}

// One or two weight gradients (both operands MN-major) in one launch of
// one instance: the first's work items, then the second's (g2 may be
// null), over min(their work, the SMs' blocks) persistent blocks.
inline cudaError_t wgmma_grads(const WgGrad& g1, const WgGrad* g2,
                               cudaStream_t stream) {
  const WgArgs a1 = wg_grad_args(g1);
  const WgArgs a2 = g2 != nullptr ? wg_grad_args(*g2) : a1;
  const int work = a1.work + (g2 != nullptr ? a2.work : 0);
  const int slots = (kWgGradTile == 64 ? 2 : 1) * sm_count();
  const int grid = work < slots ? work : slots;
  const CUtensorMap* ta2 = g2 != nullptr ? g2->ta : nullptr;
  const CUtensorMap* tb2 = g2 != nullptr ? g2->tb : nullptr;
  const WgArgs* args2 = g2 != nullptr ? &a2 : nullptr;
  if constexpr (kWgGradTile == 64)
    return launch_wgmma<64, 128, kStages64, kWgPromote, true, true, EPI_RAW>(
        *g1.ta, *g1.tb, a1, grid, stream, ta2, tb2, args2);
  return launch_wgmma<128, 128, kStages128, kWgPromote, true, true, EPI_RAW>(
      *g1.ta, *g1.tb, a1, grid, stream, ta2, tb2, args2);
}

}  // namespace vitta
