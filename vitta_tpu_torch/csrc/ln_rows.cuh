// Row LayerNorm device code, forward and backward, shared by ln.cu (the
// standalone LayerNorm) and mlp.cu (the prologue of the fused
// LayerNorm->MLP forward and the last step of its backward).
//
//   y = (x - mu) * rsqrt(E[x^2] - mu^2 + eps) * gamma + beta     per row
//
// Forward.
// One warp owns one row.  The row is read once, kept in registers while
// two shuffle reductions produce sum and sum of squares, and written once:
// the work is bound by bytes (one read and one write of the activation),
// so nothing else may touch device memory.  The vector form takes
// C == 128 * VEC (every Swin-B width); the generic form takes any C and
// reads the row a second time, which the L1 cache serves.  At bfloat16
// (x and y bfloat16, gamma, beta and every sum float32, y rounded once)
// ln_fwd_bf16x8 below takes every C % 8 == 0 up to 2048 on 16-byte aligned
// pointers in 16-byte units of 8 values (its design is at its definition);
// the generic form takes the rest (unaligned views, C % 8 != 0).
//
// Backward, from (x, gamma, dy), with xh = (x - mu) * rstd recomputed and
// wg = dy * gamma:
//   dx     = rstd * (wg - mean(wg) - xh * mean(wg * xh))         per row
//   dgamma = sum over rows of dy * xh,   dbeta = sum over rows of dy
// Bound by bytes: x and dy read once, dx written once, 3 passes over the
// activation.  One kernel makes them: a block of kLnBwdWarps warps owns a
// contiguous range of rows, and its warps walk them in groups of
// `wpr` warps a row (one warp up to C = 512 floats, 2, 4 or 8 beyond, so
// that a lane holds at most 16 floats of a row of each input; 8 in single
// floats, up to 16 warps).  A lane owns
// the same columns in every row: float4 units where C % 4 == 0 and the
// pointers are 16-byte aligned (the ragged last unit masked), single floats
// otherwise.  Where a row is short, a warp takes up to 4 rows at once, all
// their loads issued before any is used.  Each lane keeps sum dy * xh and
// sum dy for its columns in registers across the rows, in the order it takes
// them; at the end the block adds its row groups in group order through
// shared memory and writes one partial (2, C).  reduce_partials (reduce.cuh;
// reduce_sums in the projection-fused chain) adds the blocks' partials in
// block order: no float atomics, the same bits every run.  The plan
// (ln_bwd_plan) depends on rows, C and the unit alone; the grid is at most
// kLnBwdBlocks blocks of at least kLnBwdMinRows rows, so that the partials
// stay a small share of the activation.  ops/cuda_ln.py:ln_bwd_plan mirrors
// it.  The element types are template arguments: x and dx float32 or
// bfloat16 (EX), dy float32 or bfloat16 (ED; float32 with a bfloat16 x in
// the LayerNorm-MLP backward, whose dy is a float32 sum); gamma, the sums
// and the partials are float32 at either, and dx is rounded once.  A unit
// is 4 elements at both, 16 bytes of float32 or 8 of bfloat16, so that the
// plan, and the columns a lane owns, are the same at both types.

#pragma once
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "bf16.cuh"
#include "launches.cuh"
#include "reduce.cuh"

namespace vitta {

constexpr int kLnThreads = 256;                 // 8 warps = 8 rows per block
constexpr int kLnRowsPerBlock = kLnThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int VEC>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_vec(const float* __restrict__ x, const float* __restrict__ gamma,
            const float* __restrict__ beta, float* __restrict__ y,
            long long rows, float eps) {
  constexpr int C = 128 * VEC;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kLnRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float4* xr = reinterpret_cast<const float4*>(x + row * C);
  float4 v[VEC];
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    v[i] = xr[lane + 32 * i];
    s += v[i].x + v[i].y + v[i].z + v[i].w;
    sq += v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z + v[i].w * v[i].w;
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  const float mu = s * (1.0f / C);
  const float rstd = rsqrtf(sq * (1.0f / C) - mu * mu + eps);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  float4* yr = reinterpret_cast<float4*>(y + row * C);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float4 g = g4[lane + 32 * i], b = b4[lane + 32 * i];
    float4 o;
    o.x = (v[i].x - mu) * rstd * g.x + b.x;
    o.y = (v[i].y - mu) * rstd * g.y + b.y;
    o.z = (v[i].z - mu) * rstd * g.z + b.z;
    o.w = (v[i].w - mu) * rstd * g.w + b.w;
    yr[lane + 32 * i] = o;
  }
}

// 4 elements of a row (16 bytes of float32, 8 of bfloat16) or one, as
// float32, and back, rounded to nearest even at bfloat16.
template <int W>
__device__ __forceinline__ void load_elems(const float* p, float (&o)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x, o[1] = t.y, o[2] = t.z, o[3] = t.w;
  } else {
    o[0] = *p;
  }
}
template <int W>
__device__ __forceinline__ void load_elems(const bf16* p, float (&o)[W]) {
  if constexpr (W == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    o[0] = bf16_lo(t.x), o[1] = bf16_hi(t.x);
    o[2] = bf16_lo(t.y), o[3] = bf16_hi(t.y);
  } else {
    o[0] = __bfloat162float(*p);
  }
}
template <int W>
__device__ __forceinline__ void store_elems(float* p, const float (&v)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}
template <int W>
__device__ __forceinline__ void store_elems(bf16* p, const float (&v)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  else
    *p = __float2bfloat16_rn(v[0]);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float& d, float v) { d = v; }
__device__ __forceinline__ void from_float(bf16& d, float v) {
  d = __float2bfloat16_rn(v);
}

template <class E>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_any(const E* __restrict__ x, const float* __restrict__ gamma,
            const float* __restrict__ beta, E* __restrict__ y,
            long long rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kLnRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const E* xr = x + row * c;
  float s = 0.f, sq = 0.f;
  for (int j = lane; j < c; j += 32) {
    const float v = to_float(xr[j]);
    s += v;
    sq += v * v;
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  const float mu = s / c;
  const float rstd = rsqrtf(sq / c - mu * mu + eps);
  E* yr = y + row * c;
  for (int j = lane; j < c; j += 32)
    from_float(yr[j], (to_float(xr[j]) - mu) * rstd * gamma[j] + beta[j]);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// Every pointer that is not null 16-byte aligned (the bfloat16 entries'
// rule: TMA's strides and 16-byte moves).
inline bool all_aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (p != nullptr && !aligned16(p)) return false;
  return true;
}

// Launch the row LayerNorm on `stream`; returns the launch's error code.
inline cudaError_t launch_ln_rows(const float* x, const float* gamma,
                                  const float* beta, float* y, long long rows,
                                  int c, float eps, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  const unsigned blocks =
      (unsigned)((rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock);
#define VITTA_LN_CASE(V)                                                     \
  case 128 * V:                                                              \
    ln_rows_vec<V><<<blocks, kLnThreads, 0, stream>>>(x, gamma, beta, y,     \
                                                      rows, eps);            \
    count_launch("ln_rows_vec<" #V ">");                                     \
    break;
  switch (c) {
    VITTA_LN_CASE(1)
    VITTA_LN_CASE(2)
    VITTA_LN_CASE(4)
    VITTA_LN_CASE(8)
    VITTA_LN_CASE(16)
    default:
      ln_rows_any<float><<<blocks, kLnThreads, 0, stream>>>(
          x, gamma, beta, y, rows, c, eps);
      count_launch("ln_rows_any<float>");
  }
#undef VITTA_LN_CASE
  return cudaGetLastError();
}

// ------------------------------------------------------- forward, bfloat16
//
// ln_fwd_bf16x8: bfloat16 rows with C % 8 == 0 up to kLnF16MaxC on 16-byte
// aligned pointers (every Video Swin width, Swin-B's 128 * 2^k and Swin-T's
// 96 * 2^k), one launch a call.  A row is L lanes of one warp (4 to 32, a
// power of two), each holding U 16-byte units of 8 values of it, units
// lane, lane + L, ...: the fewest lanes with at most kLnF16MaxUnits units a
// lane (C = 96: 4 lanes of 3 units; 128: 8 of 2; 384: 16 of 3; 512: 32 of
// 2), and 32 lanes of up to 8 units beyond (1536: 6, 2048: 8).  A row's
// sums are each lane's over its units in order, then a butterfly over the
// row's lanes: no shared memory, no barrier.  Rows of C <= kLnF16BatchC
// are taken kLnF16Batch at a time by a row group, all their loads issued
// before any is used (64-96 bytes in flight a lane).  Each lane loads its
// units' gamma and beta into registers right after its first rows' loads
// (the L1 serves the SM's later warps), so that no row waits on a second
// trip to memory after its sums; staged in shared memory once a block,
// they put a barrier and every block's loads of the same lines before the
// sums.  Up to 255 registers a thread at 8 units: 128-thread blocks keep
// the blocks an SM holds granular.  The grid (ln_fwd_bf16_plan) shares the
// rows evenly over the blocks the card holds in one wave, at least a
// step's rows a block; a warp whose rows run out stops.  Every sum is
// float32, y is rounded once.  ops/cuda_ln.py:ln_fwd_bf16_plan mirrors the
// plan.

constexpr int kLnF16Threads = 128;      // a block: 4 warps
constexpr int kLnF16MaxUnits = 3;       // units a lane, below 32 lanes a row
constexpr int kLnF16MaxLanes = 32;      // a row within one warp
constexpr int kLnF16MaxC = 2048;
constexpr int kLnF16BatchC = 256;       // rows this wide or narrower are
constexpr int kLnF16Batch = 2;          // taken this many at a time

// Rows a row group takes at once, `units` units of `lanes` lanes a row.
__host__ __device__ constexpr int ln_fwd_batch(int units, int lanes) {
  return 8 * units * lanes <= kLnF16BatchC ? kLnF16Batch : 1;
}

// How ln_fwd_bf16x8 cuts (rows, c): `lanes` lanes a row, each holding
// `units` units; a row group takes `batch` rows at once; `blocks` blocks of
// `chunk` contiguous rows (the last may have fewer), at most `per_sm` blocks
// an SM of `sms` (one wave) unless a block would take less than a step
// (kLnF16Threads / lanes * batch rows).  units 0 where the kernel takes no
// such shape.
struct LnFwdPlan {
  int lanes, units, batch;
  long long chunk, blocks;
};

inline LnFwdPlan ln_fwd_bf16_plan(long long rows, int c, int per_sm,
                                  int sms) {
  LnFwdPlan q{0, 0, 1, 0, 0};
  if (rows <= 0 || c <= 0 || c % 8 != 0 || c > kLnF16MaxC) return q;
  const int n = c / 8;
  int lanes = 4;
  while (lanes < kLnF16MaxLanes && (n + lanes - 1) / lanes > kLnF16MaxUnits)
    lanes *= 2;
  q.lanes = lanes;
  q.units = (n + lanes - 1) / lanes;
  q.batch = ln_fwd_batch(q.units, lanes);
  const long long step = (long long)(kLnF16Threads / lanes) * q.batch;
  const long long wave = (long long)per_sm * sms;
  q.chunk = (rows + wave - 1) / wave;
  if (q.chunk < step) q.chunk = step;
  q.blocks = (rows + q.chunk - 1) / q.chunk;
  return q;
}

// The B rows from `row` of the units a lane holds, as they lie in memory
// (zero where the row or the unit does not exist).
template <int U, int L, int B>
__device__ __forceinline__ void ln_fwd_load(const bf16* __restrict__ x,
                                            long long row, long long r1,
                                            int n, int sub,
                                            uint4 (&v)[B][U]) {
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = sub + L * i;
      v[b][i] = make_uint4(0u, 0u, 0u, 0u);
      if (row + b < r1 && u < n)
        v[b][i] = *reinterpret_cast<const uint4*>(x + ((row + b) * n + u) * 8);
    }
}

__device__ __forceinline__ void unpack_bf16x8(uint4 u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = bf16_lo(w[j]);
    f[2 * j + 1] = bf16_hi(w[j]);
  }
}

// grid (plan.blocks), block kLnF16Threads.  Block b takes rows [b * chunk,
// min((b + 1) * chunk, rows)); row group g (threads g * L .. g * L + L - 1)
// takes at step s the B rows from r0 + (s * G + g) * B.
template <int U, int L>
__global__ void __launch_bounds__(kLnF16Threads)
ln_fwd_bf16x8(const bf16* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, bf16* __restrict__ y,
              long long rows, int c, long long chunk, float eps) {
  constexpr int B = ln_fwd_batch(U, L);
  constexpr int G = kLnF16Threads / L;          // row groups of a block
  const int tid = threadIdx.x, sub = tid % L;
  const int n = c >> 3;
  const long long r0 = (long long)blockIdx.x * chunk;
  const long long r1 = r0 + chunk < rows ? r0 + chunk : rows;
  const long long steps = (r1 - r0 + G * B - 1) / (G * B);
  long long row = r0 + (long long)(tid / L) * B;
  uint4 v[B][U];
  ln_fwd_load<U, L, B>(x, row, r1, n, sub, v);
  // this lane's gamma and beta, loaded while its first rows load
  float4 gm[U][2], bt[U][2];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = sub + L * i;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    gm[i][0] = gm[i][1] = bt[i][0] = bt[i][1] = zero;
    if (u < n) {
      gm[i][0] = reinterpret_cast<const float4*>(gamma)[2 * u];
      gm[i][1] = reinterpret_cast<const float4*>(gamma)[2 * u + 1];
      bt[i][0] = reinterpret_cast<const float4*>(beta)[2 * u];
      bt[i][1] = reinterpret_cast<const float4*>(beta)[2 * u + 1];
    }
  }
  const float inv_c = 1.0f / c;
  for (long long s = 0; s < steps; ++s, row += (long long)G * B) {
    // a warp whose rows have run out stops (rows only grow with s)
    if (!__any_sync(0xffffffffu, row < r1)) break;
    if (s > 0) ln_fwd_load<U, L, B>(x, row, r1, n, sub, v);
    float mu[B], rstd[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        float f[8];
        unpack_bf16x8(v[b][i], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s1 += f[j];
          s2 += f[j] * f[j];
        }
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      mu[b] = s1 * inv_c;
      rstd[b] = rsqrtf(s2 * inv_c - mu[b] * mu[b] + eps);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (row + b >= r1) break;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int u = sub + L * i;
        if (u >= n) break;
        float f[8], o[8];
        unpack_bf16x8(v[b][i], f);
        const float4 g0 = gm[i][0], g1 = gm[i][1];
        const float4 b0 = bt[i][0], b1 = bt[i][1];
        const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float be[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = (f[j] - mu[b]) * rstd[b] * g[j] + be[j];
        *reinterpret_cast<uint4*>(y + ((row + b) * n + u) * 8) =
            make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                       pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
      }
    }
  }
}

// The instances: (units, lanes) as ln_fwd_bf16_plan picks them for C up to
// kLnF16MaxC.
#define VITTA_LN_F16_INSTANCES(X)                                          \
  X(1, 4) X(2, 4) X(3, 4) X(2, 8) X(3, 8) X(2, 16) X(3, 16) X(2, 32)        \
  X(3, 32) X(4, 32) X(5, 32) X(6, 32) X(7, 32) X(8, 32)

// Blocks of an instance an SM holds at once (the card's own answer, read
// once; 1 where it cannot be read).  Internal linkage: each library reads
// its own instance.
namespace {
template <int U, int L>
int ln_fwd_per_sm() {
  static const int n = [] {
    int k = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &k, ln_fwd_bf16x8<U, L>, kLnF16Threads, 0) != cudaSuccess ||
        k < 1) {
      cudaGetLastError();
      k = 1;
    }
    return k;
  }();
  return n;
}

// The plan at (rows, c) with what it was made for: the blocks of its
// instance an SM holds (*per_sm) on the card's SMs (sm_count()).
inline LnFwdPlan ln_fwd_bf16_plan_of(long long rows, int c, int* per_sm) {
  const LnFwdPlan shape = ln_fwd_bf16_plan(rows, c, 1, 1);
  *per_sm = 0;
#define VITTA_LN_F16_PER_SM(U, L)                 \
  if (shape.units == U && shape.lanes == L)       \
    *per_sm = ln_fwd_per_sm<U, L>();
  VITTA_LN_F16_INSTANCES(VITTA_LN_F16_PER_SM)
#undef VITTA_LN_F16_PER_SM
  if (*per_sm == 0) return LnFwdPlan{0, 0, 1, 0, 0};
  return ln_fwd_bf16_plan(rows, c, *per_sm, sm_count());
}
}  // namespace

// The same at bfloat16 (x, y bfloat16): ln_fwd_bf16x8 where C % 8 == 0, C
// <= kLnF16MaxC and x, y, gamma and beta are 16-byte aligned, one value at
// a time otherwise (ln_rows_any), with the same values.
inline cudaError_t launch_ln_rows(const bf16* x, const float* gamma,
                                  const float* beta, bf16* y, long long rows,
                                  int c, float eps, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  if (all_aligned16({x, y, gamma, beta})) {
    int per_sm = 0;
    const LnFwdPlan q = ln_fwd_bf16_plan_of(rows, c, &per_sm);
#define VITTA_LN_F16_CASE(U, L)                                              \
  if (q.units == U && q.lanes == L) {                                        \
    ln_fwd_bf16x8<U, L><<<(unsigned)q.blocks, kLnF16Threads, 0, stream>>>(   \
        x, gamma, beta, y, rows, c, q.chunk, eps);                           \
    count_launch("ln_fwd_bf16x8<" #U ", " #L ">");                          \
    return cudaGetLastError();                                               \
  }
    VITTA_LN_F16_INSTANCES(VITTA_LN_F16_CASE)
#undef VITTA_LN_F16_CASE
  }
  ln_rows_any<bf16><<<(unsigned)((rows + kLnRowsPerBlock - 1) /
                                 kLnRowsPerBlock),
                      kLnThreads, 0, stream>>>(x, gamma, beta, y, rows, c,
                                               eps);
  count_launch("ln_rows_any<__nv_bfloat16>");
  return cudaGetLastError();
}

// ---------------------------------------------------------------- backward

constexpr int kLnBwdWarps = 16;                 // one block an SM
constexpr int kLnBwdThreads = 32 * kLnBwdWarps;
constexpr int kLnBwdBlocks = 132;               // an H100's SMs
constexpr int kLnBwdMinRows = 8;                // rows a block takes at least
// floats of a row a lane holds per input: 4 float4 units, or 8 single
// floats (16 spill: their indices and masks take the registers)
constexpr int kLnBwdLaneFloats = 16;
constexpr int kLnBwdLaneScalars = 8;
constexpr int kLnBwdMaxBatch = 4;               // rows a warp takes at once
constexpr int kLnBwdMaxC = 8 * 32 * kLnBwdLaneFloats;   // 4096
// groups * c <= kLnBwdWarps / wpr * (32 * wpr * kLnBwdLaneFloats)
constexpr int kLnBwdRedFloats = kLnBwdWarps * 32 * kLnBwdLaneFloats;

// How the backward cuts its work; ops/cuda_ln.py:ln_bwd_plan mirrors it.
struct LnBwdPlan {
  int vec;           // float4 units (1) or single floats (0)
  int units;         // units a lane holds of a row
  int batch;         // rows a warp takes at once (1 where wpr > 1)
  int wpr;           // warps a row
  long long blocks;  // the grid, and the number of partials
  long long rows_per_block;
};

// The plan for (rows, c) in 16-byte units (vec) or single floats; units 0
// where c is too wide (> kLnBwdMaxC) or the arguments are no shape.
inline LnBwdPlan ln_bwd_plan(long long rows, int c, bool vec) {
  LnBwdPlan q{vec ? 1 : 0, 0, 1, 1, 0, 0};
  const int w = vec ? 4 : 1;
  if (rows <= 0 || c <= 0 || c > kLnBwdMaxC || (vec && c % 4 != 0)) return q;
  const int n = c / w;                          // units in a row
  auto per_lane = [&](int wpr) { return (n + 32 * wpr - 1) / (32 * wpr); };
  const int most = vec ? kLnBwdLaneFloats : kLnBwdLaneScalars;
  while (per_lane(q.wpr) * w > most) q.wpr *= 2;
  q.units = per_lane(q.wpr);
  if (!vec)                                    // 1, 2, 4 or 8 floats
    while (q.units & (q.units - 1)) q.units += q.units & -q.units;
  if (q.wpr == 1) {
    q.batch = kLnBwdLaneFloats / (q.units * w);
    if (q.batch > kLnBwdMaxBatch) q.batch = kLnBwdMaxBatch;
  }
  q.blocks = (rows + kLnBwdMinRows - 1) / kLnBwdMinRows;
  if (q.blocks > kLnBwdBlocks) q.blocks = kLnBwdBlocks;
  q.rows_per_block = (rows + q.blocks - 1) / q.blocks;
  q.blocks = (rows + q.rows_per_block - 1) / q.rows_per_block;
  return q;
}

// Whether p starts on a boundary of a unit of 4 elements of its type.
template <class E>
inline bool unit_aligned(const E* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & (4 * sizeof(E) - 1)) == 0;
}

// Whether the backward may take units of 4 elements on these pointers
// (gamma, float32, in 16 bytes).
template <class EX, class ED>
inline bool ln_bwd_vec_ok(const EX* x, const float* gamma, const ED* dy,
                          const EX* dx, int c) {
  return c % 4 == 0 && unit_aligned(x) && aligned16(gamma) &&
         unit_aligned(dy) && unit_aligned(dx);
}

// The number of (2, c) partials the backward leaves, one a block; the same
// for both units.
inline long long ln_bwd_partial_count(long long rows, int c) {
  return ln_bwd_plan(rows, c, false).blocks;
}

// Floats of scratch the backward needs: its partials.
inline long long ln_bwd_scratch_floats(long long rows, int c) {
  return ln_bwd_partial_count(rows, c) * 2 * c;
}

// The name of a backward instance: "ln_bwd_kernel<vec, units, batch>" at
// float32, with the two element types appended otherwise.
inline const char* type_tag(const float*) { return "float"; }
inline const char* type_tag(const bf16*) { return "__nv_bfloat16"; }

template <class EX, class ED>
std::string ln_bwd_name(bool vec, int units, int batch) {
  std::string s = template_name("ln_bwd_kernel", vec, units, batch);
  if (sizeof(EX) == 4 && sizeof(ED) == 4) return s;
  s.pop_back();
  return s + ", " + type_tag((const EX*)nullptr) + ", " +
         type_tag((const ED*)nullptr) + ">";
}

// grid (plan.blocks), block kLnBwdThreads.  Block b takes rows [b * rpb,
// min((b + 1) * rpb, rows)); its warps form kLnBwdWarps / wpr groups of wpr
// warps, and at step s group g takes the BATCH rows from
// r0 + (s * groups + g) * BATCH.  A lane of warp k of its group owns units
// t, t + 32 * wpr, ... (UNITS of them), t = 32 * k + lane; a unit is W = 4
// elements (VEC) or 1, held as float32 whatever EX and ED are.
template <bool VEC, int UNITS, int BATCH, class EX, class ED>
__global__ void __launch_bounds__(kLnBwdThreads, 1)
ln_bwd_kernel(const EX* __restrict__ x, const float* __restrict__ gamma,
              const ED* __restrict__ dy, EX* __restrict__ dx,
              float* __restrict__ partial, long long rows, int c, int wpr,
              long long rows_per_block, float eps) {
  constexpr int W = VEC ? 4 : 1;
  __shared__ float red[kLnBwdRedFloats];        // (groups, c)
  __shared__ float2 xch[2][kLnBwdWarps * BATCH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = kLnBwdWarps / wpr, grp = warp / wpr;
  const int t = (warp - grp * wpr) * 32 + lane, stride = 32 * wpr;
  const int n = c / W;
  float gm[UNITS][W];
  float acc_g[UNITS * W], acc_b[UNITS * W];
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int u = t + stride * i;
    if (u < n) {
      load_elems<W>(gamma + (long long)u * W, gm[i]);
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) gm[i][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < W; ++k) acc_g[i * W + k] = acc_b[i * W + k] = 0.f;
  }
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const long long steps = (r1 - r0 + (long long)groups * BATCH - 1) /
                          ((long long)groups * BATCH);
  const float inv_c = 1.0f / c;
  for (long long s = 0; s < steps; ++s) {
    const long long base = r0 + (s * groups + grp) * BATCH;
    float xv[BATCH][UNITS][W], dv[BATCH][UNITS][W];
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
#pragma unroll
      for (int i = 0; i < UNITS; ++i) {
        const int u = t + stride * i;
        if (base + b < r1 && u < n) {
          const long long at = ((base + b) * n + u) * W;
          load_elems<W>(x + at, xv[b][i]);
          load_elems<W>(dy + at, dv[b][i]);
        } else {
#pragma unroll
          for (int k = 0; k < W; ++k) xv[b][i][k] = dv[b][i][k] = 0.f;
        }
      }
    // the rows' sums and sums of squares, over the row's warps
    float mu[BATCH], rstd[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      float sm = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < UNITS; ++i)
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const float v = xv[b][i][k];
          sm += v;
          sq += v * v;
        }
      mu[b] = warp_sum(sm);
      rstd[b] = warp_sum(sq);
    }
    if (wpr > 1) {
      if (lane == 0)
#pragma unroll
        for (int b = 0; b < BATCH; ++b)
          xch[0][warp * BATCH + b] = make_float2(mu[b], rstd[b]);
      __syncthreads();
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        float2 v = xch[0][grp * wpr * BATCH + b];
        for (int k = 1; k < wpr; ++k) {
          const float2 o = xch[0][(grp * wpr + k) * BATCH + b];
          v.x += o.x, v.y += o.y;
        }
        mu[b] = v.x, rstd[b] = v.y;
      }
    }
    // xh in place of x; the sums of wg and wg * xh
    float ma[BATCH], mb[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const float m = mu[b] * inv_c;
      const float r = rsqrtf(rstd[b] * inv_c - m * m + eps);
      mu[b] = m, rstd[b] = r;
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int i = 0; i < UNITS; ++i)
#pragma unroll
        for (int k = 0; k < W; ++k) {
          float& v = xv[b][i][k];
          v = (v - m) * r;
          const float wg = dv[b][i][k] * gm[i][k];
          sa += wg;
          sb += wg * v;
        }
      ma[b] = warp_sum(sa);
      mb[b] = warp_sum(sb);
    }
    if (wpr > 1) {
      if (lane == 0)
#pragma unroll
        for (int b = 0; b < BATCH; ++b)
          xch[1][warp * BATCH + b] = make_float2(ma[b], mb[b]);
      __syncthreads();
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        float2 v = xch[1][grp * wpr * BATCH + b];
        for (int k = 1; k < wpr; ++k) {
          const float2 o = xch[1][(grp * wpr + k) * BATCH + b];
          v.x += o.x, v.y += o.y;
        }
        ma[b] = v.x, mb[b] = v.y;
      }
    }
    // dx, and this lane's column sums, row after row
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      if (base + b >= r1) break;
      const float a = ma[b] * inv_c, bb = mb[b] * inv_c, r = rstd[b];
#pragma unroll
      for (int i = 0; i < UNITS; ++i) {
        const int u = t + stride * i;
        if (u >= n) break;
        float o[W];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const float xh = xv[b][i][k], d = dv[b][i][k];
          o[k] = r * (d * gm[i][k] - a - xh * bb);
          acc_g[i * W + k] += d * xh;
          acc_b[i * W + k] += d;
        }
        store_elems<W>(dx + ((base + b) * n + u) * W, o);
      }
    }
  }
  // the block's partial: its groups added in group order, dgamma then dbeta
  float* out = partial + (long long)blockIdx.x * 2 * c;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = t + stride * i;
      if (u < n)
#pragma unroll
        for (int k = 0; k < W; ++k)
          red[grp * c + u * W + k] = part == 0 ? acc_g[i * W + k]
                                               : acc_b[i * W + k];
    }
    __syncthreads();
    for (int col = threadIdx.x; col < c; col += kLnBwdThreads) {
      float v = red[col];
      for (int g = 1; g < groups; ++g) v += red[g * c + col];
      out[part * c + col] = v;
    }
    __syncthreads();
  }
}

template <bool VEC, int UNITS, int BATCH, class EX, class ED>
cudaError_t launch_ln_bwd_kernel(const LnBwdPlan& q, const EX* x,
                                 const float* gamma, const ED* dy, EX* dx,
                                 float* partial, long long rows, int c,
                                 float eps, cudaStream_t stream) {
  ln_bwd_kernel<VEC, UNITS, BATCH, EX, ED>
      <<<(unsigned)q.blocks, kLnBwdThreads, 0, stream>>>(
          x, gamma, dy, dx, partial, rows, c, q.wpr, q.rows_per_block, eps);
  static const std::string name = ln_bwd_name<EX, ED>(VEC, UNITS, BATCH);
  count_launch(name.c_str());
  return cudaGetLastError();
}

// The first launch of the LayerNorm backward on `stream`: dx (rows, c) and
// the blocks' partials (ln_bwd_partial_count of them, (2, c) each) in
// `scratch`, which a reduce adds up (launch_ln_bwd's own, or a chain's one
// reduce_sums).  vec: units of 4 elements, which the caller has checked
// (ln_bwd_vec_ok).  Returns the launch's error.
template <class EX, class ED>
inline cudaError_t launch_ln_bwd_parts(const EX* x, const float* gamma,
                                       const ED* dy, EX* dx, float* scratch,
                                       long long rows, int c, float eps,
                                       bool vec, cudaStream_t stream) {
  const LnBwdPlan q = ln_bwd_plan(rows, c, vec);
  if (q.units == 0) return cudaErrorInvalidValue;
#define VITTA_LN_BWD_CASE(V, UN, B)                                          \
  if (vec == V && q.units == UN && q.batch == B)                             \
    return launch_ln_bwd_kernel<V, UN, B>(q, x, gamma, dy, dx, scratch, rows, \
                                          c, eps, stream);
  VITTA_LN_BWD_CASE(true, 1, 4)
  VITTA_LN_BWD_CASE(true, 2, 2)
  VITTA_LN_BWD_CASE(true, 3, 1)
  VITTA_LN_BWD_CASE(true, 4, 1)
  VITTA_LN_BWD_CASE(false, 1, 4)
  VITTA_LN_BWD_CASE(false, 2, 4)
  VITTA_LN_BWD_CASE(false, 4, 4)
  VITTA_LN_BWD_CASE(false, 8, 2)
  VITTA_LN_BWD_CASE(false, 8, 1)
#undef VITTA_LN_BWD_CASE
  return cudaErrorInvalidValue;
}

// The LayerNorm backward on `stream`, two launches: dx (rows, c), dgb (2, c)
// = (dgamma, dbeta); scratch as ln_bwd_scratch_floats says.  Returns the
// first launch error.
template <class EX, class ED>
inline cudaError_t launch_ln_bwd(const EX* x, const float* gamma,
                                 const ED* dy, EX* dx, float* dgb,
                                 float* scratch, long long rows, int c,
                                 float eps, bool vec, cudaStream_t stream) {
  const cudaError_t e = launch_ln_bwd_parts(x, gamma, dy, dx, scratch, rows,
                                            c, eps, vec, stream);
  if (e != cudaSuccess) return e;
  return launch_reduce_partials(scratch, dgb,
                                (int)ln_bwd_partial_count(rows, c), 2LL * c,
                                stream);
}

}  // namespace vitta
