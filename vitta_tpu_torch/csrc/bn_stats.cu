// BatchNorm (inference form) + optional ReLU + channel statistics of the
// output, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of vitta_tpu/ops/pallas_stats.py:
//   _kernel (:41, launched by fused_bn_relu_stats :68).
// The TPU function has no backward (nothing differentiates it there); the
// port's BatchNorm calls this op on the adaptation path, so the backward is
// written here.
//
// What it computes, for x (R, C) with channels last and per-channel
// scale, bias, mean, var (C), all float32, or x, y, g_y and dx bfloat16:
//   y = (x - mean) * rsqrt(var + eps) * scale + bias,  y = max(y, 0) if relu
//   m = sum_rows(y) / R,  v = sum_rows(y^2) / R - m^2          (both (C))
// and, from the cotangents g_y (R, C), g_m (C), g_v (C), each of which may
// be absent (a null pointer: zero), with inv = rsqrt(var + eps) * scale and
// xhat = (x - mean) * rsqrt(var + eps):
//   G = g_y + g_m / R + g_v * 2 (y - m) / R,   G = 0 where relu cut y
//   dx = G * inv,  dscale = sum_rows(G * xhat),  dbias = sum_rows(G)
// y is recomputed from x in the backward; mean and var get no gradient.
//
// At bfloat16 the arithmetic is float32 and y is rounded to bfloat16 where
// it is stored; m and v are the statistics of that rounded y, as
// vitta_tpu/models/layers.py:183-190 (the BatchNorm this op serves there)
// taps them from y.astype(float32), and the backward's y in the g_v term
// is the rounded one too.  G stays float32; dx is rounded to bfloat16 once.
// (The Pallas kernel, which no vitta_tpu model calls, sums the unrounded y:
// pallas_stats.py:54-57.)
//
// What bounds it: bytes.  A dozen operations per element against one read of
// x and one write of y (backward: x and g_y read, dx written).  At the
// sizes a TANet step gives it (1568-25088 rows, 256-2048 channels, 1-6 MB
// of x at bfloat16) a call moves its bytes in 1-4 us, so what decides its
// time is how soon the card is full of loads and how short the tail is.
// The design, one launch a call:
// - threads run along C, so a warp reads neighbouring addresses of one row,
//   16 bytes a thread where C is a multiple of 4 (of 8 at bfloat16; one
//   element a thread where not, or where a view starts off a 16-byte
//   boundary); a block of 8 warps owns a chunk of rows and a tile of
//   columns and keeps each column's sums in registers; the grid is one
//   wave of at most two blocks an SM (bn_plan);
// - each thread issues the loads of its first rows, then the block stages
//   the tile's parameters in shared memory (a column a thread, one
//   coalesced load of each), and from then on a thread issues the loads of
//   its next kBnDepth* rows (8 apart) before it works on the ones it has;
//   the backward reads its seven parameters back from shared memory for
//   each batch of rows, so that its registers hold the next batch instead;
// - the TPU kernel adds into one scratch block that its sequential grid
//   revisits; a CUDA grid has no order, so the sums go up in a fixed order:
//   a thread's rows in row order, the block's 8 warps in order, the blocks
//   of a cluster (up to 8 along the rows) in rank order at rank 0, into
//   whose shared memory the others store their sums with st.async, rank 0
//   writing one partial, then the tile's partials in chunk order by the
//   block that draws the tile's last ticket (an integer atomic; no float
//   atomic), loading kBnSumAhead of them at once.  Two runs are bit-equal
//   whichever block draws it.  That block resets its ticket to 0, so a
//   ticket is 0 between launches: the tickets are this library's own
//   zero-initialised device array, a slot of them per stream (the wrapper
//   hands out the slots), which CUDA graphs capture and replay as they are
//   (tickets.cuh, shared with ln.cu and tam.cu).
// tools/bn_variants.py builds copies with other constants and times them
// in turns with another checkout's kernels.
// The TPU kernel's row tile (a divisor of R, a multiple of 8) has no
// counterpart: any R and any C >= 1 are taken.

#include <cuda_bf16.h>

#include <cstdint>
#include <initializer_list>

#include "launches.cuh"
#include "tickets.cuh"

namespace vitta {

constexpr int kBnLanes = 32;       // threads along C
constexpr int kBnWarps = 8;        // row groups: the block's warps
constexpr int kBnThreads = kBnLanes * kBnWarps;
constexpr int kBnDepthFwd = 4;     // rows whose loads a thread issues at once
constexpr int kBnDepthFwd8 = 2;    // (8 bfloat16 values a row, in the forward;
constexpr int kBnDepthBwd = 2;     // the backward loads x and g_y of each)
constexpr int kBnBlocksPerSm = 2;  // blocks an SM holds (caps registers),
                                   // and the grid aims at no more
constexpr int kBnMinChunk = 32;    // fewest rows a block takes
constexpr int kBnMaxCluster = 8;   // blocks of a cluster, along the rows
constexpr int kBnSumAhead = 8;     // partials the last block loads at once

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// How a call cuts (rows, c) at V columns a thread: grid (chunks, tiles),
// clusters of csize blocks along the rows, chunk rows a block.  All blocks
// fit in one wave, shared evenly by the tiles: at most `resident` clusters
// of kBnMaxCluster blocks of the kernel (what the card holds at once,
// BnKernel::resident) and at most kBnBlocksPerSm blocks an SM of `sms`.
// The cluster is the largest (up to kBnMaxCluster) whose multiples leave
// at most an eighth of a tile's share of blocks unused, and no larger than
// the rows allow; each block takes at least kBnMinChunk rows; chunks is a
// multiple of csize (the last blocks may have no rows).
// ops/cuda_stats.py:bn_plan mirrors it.
struct BnPlan {
  int tiles, csize;
  long long chunk, chunks;
};

inline BnPlan bn_plan(long long rows, int c, int v, int resident, int sms) {
  BnPlan p;
  p.tiles = (int)cdiv(c, kBnLanes * v);
  const long long by_sm = (long long)kBnBlocksPerSm * sms;
  const long long wave = (long long)resident * kBnMaxCluster < by_sm
                             ? (long long)resident * kBnMaxCluster
                             : by_sm;
  const long long share = wave / p.tiles > 1 ? wave / p.tiles : 1;
  p.csize = kBnMaxCluster;
  while (p.csize > 1 && share / p.csize * p.csize * 8 < 7 * share)
    p.csize /= 2;
  const long long blocks = share / p.csize * p.csize;
  p.chunk = cdiv(cdiv(rows, blocks), kBnWarps) * kBnWarps;
  if (p.chunk < kBnMinChunk) p.chunk = kBnMinChunk;
  const long long n = cdiv(rows, p.chunk);
  while (p.csize > n) p.csize /= 2;
  p.chunks = cdiv(n, p.csize) * p.csize;
  return p;
}

// Floats of the partials: (chunks / csize, 2, c).
inline long long bn_partial_floats(const BnPlan& p, int c) {
  return p.chunks / p.csize * 2 * (long long)c;
}

using bf16 = __nv_bfloat16;

// V values of type E from p as float32 (16 bytes where V > 1), and back,
// rounded to nearest even at bfloat16.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    out[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&in)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    *p = in[0];
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const bf16* p, float (&out)[V]) {
  if constexpr (V == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[2 * j] = __uint_as_float(w[j] << 16);
      out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    out[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(bf16* p, const float (&in)[V]) {
  if constexpr (V == 8) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(in[2 * j], in[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *p = __float2bfloat16_rn(in[0]);
  }
}

// v rounded to E, as float32: the value store_vec writes (the identity at
// float32).
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// V floats to and from shared memory, 16 bytes at a time where V > 1.
template <int V>
__device__ __forceinline__ void put_row(float* p, const float (&in)[V]) {
  if constexpr (V == 1) {
    *p = in[0];
  } else {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(in[j], in[j + 1], in[j + 2], in[j + 3]);
  }
}

template <int V>
__device__ __forceinline__ void get_row(const float* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = *p;
  } else {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + j);
      out[j] = t.x; out[j + 1] = t.y; out[j + 2] = t.z; out[j + 3] = t.w;
    }
  }
}

// D rows of V values, kBnWarps rows apart from row r, all loads issued
// before any is used; rows from r1 on are not read.
template <int D, int V, class E>
__device__ __forceinline__ void load_rows(const E* __restrict__ x,
                                          float (&v)[D][V], long long r,
                                          long long r1, int c, int col) {
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (r + d * kBnWarps < r1)
      load_vec<V>(x + (r + d * kBnWarps) * c + col, v[d]);
}

template <int D, int V>
__device__ __forceinline__ void copy_rows(const float (&from)[D][V],
                                          float (&to)[D][V]) {
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int j = 0; j < V; ++j) to[d][j] = from[d][j];
}

// Clusters: the blocks of one arrive at a barrier when they start; rank 0
// waits on an mbarrier for the others' sums, which they store into its
// shared memory with st.async (each completes its bytes on the mbarrier),
// so no block waits for its own stores to land.

template <int V, int NP>
struct BnShared {
  float params[NP][kBnLanes * V];             // the tile's, a column each
  float warps[kBnWarps][2][kBnLanes * V];     // each warp's two sums
  float2 ranks[kBnMaxCluster][kBnLanes * V];  // each block's, at rank 0
  unsigned long long bar;                     // rank 0: the others' landed
  int last;                                   // drew the last ticket
};

// Every thread of a block calls it first: rank 0 of a cluster makes its
// mbarrier (one arrival, its own, and the others' bytes), then the
// cluster's blocks arrive at the cluster's barrier.
template <class S>
__device__ __forceinline__ void bn_start(S& sh, int csize) {
  if (csize == 1) return;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    if (cluster_rank() == 0)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&sh.bar))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_arrive_relaxed();
}

// The block's two sums of V columns a thread, a and b, over all rows: over
// the warps, the cluster's blocks and the tile's clusters, each in order,
// as the header says.  Writes out[col] and out[c + col] for the tile's
// columns: the two sums or, with STATS, m = a / R and v = b / R - m^2 from
// compensated sums over the clusters (E[y^2] - m^2 cancels where |m| is far
// above the spread).  Every thread of the block calls it.  A block's
// ticket is one thread's acquire-release atomic after the block's barrier,
// as a grid barrier of cooperative groups orders a block's writes.
template <int V, bool STATS, class S>
__device__ __forceinline__ void bn_sums(S& sh, const float (&a)[V],
                                        const float (&b)[V],
                                        float* __restrict__ partial,
                                        unsigned* __restrict__ tickets,
                                        float* __restrict__ out, int c,
                                        int csize, float inv_rows) {
  constexpr int kCols = kBnLanes * V;
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * kBnLanes + tx;
  put_row<V>(&sh.warps[ty][0][tx * V], a);
  put_row<V>(&sh.warps[ty][1][tx * V], b);
  __syncthreads();
  float sa = 0.f, sb = 0.f;
  if (t < kCols) {
#pragma unroll
    for (int w = 0; w < kBnWarps; ++w) {
      sa += sh.warps[w][0][t];
      sb += sh.warps[w][1][t];
    }
  }
  if (csize > 1) {
    const unsigned rank = cluster_rank();
    const uint32_t bar = smem_addr(&sh.bar);
    cluster_wait();                  // every block started: the mbarrier is
    if (rank != 0) {                 // made
      if (t < kCols) {
        uint32_t at = smem_addr(&sh.ranks[rank][t]), bar0;
        asm volatile("mapa.shared::cluster.u32 %0, %0, 0;" : "+r"(at));
        asm volatile("mapa.shared::cluster.u32 %0, %1, 0;"
                     : "=r"(bar0) : "r"(bar));
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
            "[%0], {%1, %2}, [%3];" ::"r"(at), "f"(sa), "f"(sb), "r"(bar0)
            : "memory");
      }
      return;
    }
    if (t < kCols) sh.ranks[0][t] = make_float2(sa, sb);
    if (t == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                       "r"(bar), "r"((unsigned)((csize - 1) * kCols * 8))
                   : "memory");
    asm volatile(
        "{\n.reg .pred p;\nBN_WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
        "@!p bra BN_WAIT_%=;\n}" ::"r"(bar)
        : "memory");
    __syncthreads();                 // rank 0's own sums too
    sa = 0.f;
    sb = 0.f;
    if (t < kCols)
      for (int k = 0; k < csize; ++k) {
        const float2 u = sh.ranks[k][t];
        sa += u.x;
        sb += u.y;
      }
  }
  const long long parts = gridDim.x / csize;
  const long long stride = 2LL * c;
  const int col = blockIdx.y * kCols + t;
  const bool active = t < kCols && col < c;
  if (active) {
    float* p = partial + blockIdx.x / csize * stride + col;
    p[0] = sa;
    p[c] = sb;
  }
  __syncthreads();
  if (t == 0)                        // releases the block's partials and, to
    sh.last = draw_last_ticket(      // the last, acquires all the others'
        tickets + blockIdx.y, (unsigned)parts);
  __syncthreads();
  if (!sh.last) return;
  if (active) {
    // the partials straight from L2, kBnSumAhead of each sum in flight
    const float* pa = partial + col;
    float s = 0.f, ss = 0.f, cs = 0.f, css = 0.f;
#pragma unroll 1
    for (long long p0 = 0; p0 < parts; p0 += kBnSumAhead) {
      float va[kBnSumAhead], vb[kBnSumAhead];
#pragma unroll
      for (int u = 0; u < kBnSumAhead; ++u) {
        const bool ok = p0 + u < parts;
        va[u] = ok ? __ldcg(pa + (p0 + u) * stride) : 0.f;
        vb[u] = ok ? __ldcg(pa + (p0 + u) * stride + c) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBnSumAhead; ++u) {
        if (p0 + u >= parts) break;
        if (STATS) {           // compensated (Kahan)
          const float x1 = va[u] - cs, t1 = s + x1;
          cs = (t1 - s) - x1;
          s = t1;
          const float x2 = vb[u] - css, t2 = ss + x2;
          css = (t2 - ss) - x2;
          ss = t2;
        } else {
          s += va[u];
          ss += vb[u];
        }
      }
    }
    if (STATS) {
      const float m = s * inv_rows;
      out[col] = m;
      out[c + col] = ss * inv_rows - m * m;
    } else {
      out[col] = s;
      out[c + col] = ss;
    }
  }
}

// grid (chunks, tiles), block (32, 8), clusters of csize along x.  stats
// (2, c): m, then v.  partial (chunks / csize, 2, c): each cluster's sums
// of y and of y^2.
template <int V, bool RELU, class E>
__global__ void __launch_bounds__(kBnThreads, kBnBlocksPerSm)
bn_stats_fwd_kernel(const E* __restrict__ x,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ mean,
                    const float* __restrict__ var, E* __restrict__ y,
                    float* __restrict__ stats, float* __restrict__ partial,
                    int slot, long long rows, long long chunk, int c,
                    int csize, float eps) {
  constexpr int kCols = kBnLanes * V;
  constexpr int D = V == 8 ? kBnDepthFwd8 : kBnDepthFwd;
  __shared__ __align__(16) BnShared<V, 2> sh;
  bn_start(sh, csize);
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * kBnLanes + tx;
  const int col = blockIdx.y * kCols + tx * V;
  const bool active = col < c;      // c is a multiple of V
  const long long r0 = (long long)blockIdx.x * chunk;
  const long long r1 = r0 + chunk < rows ? r0 + chunk : rows;
  const long long rb = r0 + ty;
  float v[D][V];
  if (active) load_rows<D, V>(x, v, rb, r1, c, col);
  // while the first rows load: the tile's parameters, a column a thread
  const int pc = blockIdx.y * kCols + t;
  if (t < kCols && pc < c) {
    const float i = rsqrtf(var[pc] + eps) * scale[pc];
    sh.params[0][t] = i;
    sh.params[1][t] = bias[pc] - mean[pc] * i;
  }
  __syncthreads();
  float inv[V], shift[V], s[V], ss[V];
  get_row<V>(&sh.params[0][tx * V], inv);
  get_row<V>(&sh.params[1][tx * V], shift);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s[j] = 0.f;
    ss[j] = 0.f;
  }
  if (active) {
    for (long long r = rb; r < r1; r += kBnWarps * D) {
      float next[D][V];             // the next rows load while these go
      load_rows<D, V>(x, next, r + kBnWarps * D, r1, c, col);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (r + d * kBnWarps >= r1) break;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float u = fmaf(v[d][j], inv[j], shift[j]);
          if (RELU) u = fmaxf(u, 0.f);
          u = round_to(u, y);        // the statistics are of the stored y
          v[d][j] = u;
          s[j] += u;
          ss[j] = fmaf(u, u, ss[j]);
        }
        store_vec<V>(y + (r + d * kBnWarps) * c + col, v[d]);
      }
      copy_rows<D, V>(next, v);
    }
  }
  bn_sums<V, true>(sh, s, ss, partial,
                   slot_tickets(slot), stats, c,
                   csize, 1.f / (float)rows);
}

// grid (chunks, tiles), block (32, 8), clusters of csize along x.  dsb
// (2, c): dscale, then dbias.  partial (chunks / csize, 2, c): each
// cluster's sums of G * xhat and of G.  g_y, g_m, g_v may be null.
template <int V, bool RELU, class E>
__global__ void __launch_bounds__(kBnThreads, kBnBlocksPerSm)
bn_stats_bwd_kernel(const E* __restrict__ x,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ mean,
                    const float* __restrict__ var,
                    const float* __restrict__ m,
                    const E* __restrict__ g_y,
                    const float* __restrict__ g_m,
                    const float* __restrict__ g_v, E* __restrict__ dx,
                    float* __restrict__ dsb, float* __restrict__ partial,
                    int slot, long long rows, long long chunk, int c,
                    int csize, float eps) {
  constexpr int kCols = kBnLanes * V, D = kBnDepthBwd;
  __shared__ __align__(16) BnShared<V, 7> sh;
  bn_start(sh, csize);
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * kBnLanes + tx;
  const int col = blockIdx.y * kCols + tx * V;
  const bool active = col < c;
  const long long r0 = (long long)blockIdx.x * chunk;
  const long long r1 = r0 + chunk < rows ? r0 + chunk : rows;
  const long long rb = r0 + ty;
  const float inv_rows = 1.f / (float)rows;
  float v[D][V], g[D][V];
  if (active) {
    load_rows<D, V>(x, v, rb, r1, c, col);
    if (g_y) load_rows<D, V>(g_y, g, rb, r1, c, col);
  }
  // while the first rows load: the tile's parameters, a column a thread
  const int pc = blockIdx.y * kCols + t;
  if (t < kCols && pc < c) {
    const float rstd = rsqrtf(var[pc] + eps), inv = rstd * scale[pc];
    sh.params[0][t] = rstd;
    sh.params[1][t] = inv;
    sh.params[2][t] = mean[pc];
    sh.params[3][t] = bias[pc] - mean[pc] * inv;
    sh.params[4][t] = m[pc];
    sh.params[5][t] = g_m ? g_m[pc] * inv_rows : 0.f;
    sh.params[6][t] = g_v ? 2.f * g_v[pc] * inv_rows : 0.f;
  }
  __syncthreads();
  float ds[V], db[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ds[j] = 0.f;
    db[j] = 0.f;
  }
  // the parameters are read from shared memory for each batch of rows,
  // four columns at a time, so that the registers hold a second batch of
  // rows in flight instead
  constexpr int kGroup = V < 4 ? V : 4;
  if (active) {
    for (long long r = rb; r < r1; r += kBnWarps * D) {
      float next_v[D][V], next_g[D][V];   // the next rows load meanwhile
      load_rows<D, V>(x, next_v, r + kBnWarps * D, r1, c, col);
      if (g_y) load_rows<D, V>(g_y, next_g, r + kBnWarps * D, r1, c, col);
      asm volatile("" ::: "memory");     // read the parameters again
#pragma unroll
      for (int h = 0; h < V; h += kGroup) {
        float pr[7][kGroup];               // rstd, inv, mean, shift, m,
#pragma unroll                             // g_m / R, 2 g_v / R
        for (int k = 0; k < 7; ++k)
          get_row<kGroup>(&sh.params[k][tx * V + h], pr[k]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          if (r + d * kBnWarps >= r1) break;
#pragma unroll
          for (int jj = 0; jj < kGroup; ++jj) {
            const int j = h + jj;
            const float u = fmaf(v[d][j], pr[1][jj], pr[3][jj]);
            const float yv = round_to(RELU ? fmaxf(u, 0.f) : u, x);
            float G = (g_y ? g[d][j] : 0.f) + pr[5][jj] +
                      pr[6][jj] * (yv - pr[4][jj]);
            if (RELU && !(u > 0.f)) G = 0.f;
            ds[j] = fmaf(G, (v[d][j] - pr[2][jj]) * pr[0][jj], ds[j]);
            db[j] += G;
            g[d][j] = G * pr[1][jj];
          }
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (r + d * kBnWarps < r1)
          store_vec<V>(dx + (r + d * kBnWarps) * c + col, g[d]);
      copy_rows<D, V>(next_v, v);
      copy_rows<D, V>(next_g, g);
    }
  }
  bn_sums<V, false>(sh, ds, db, partial,
                    slot_tickets(slot), dsb, c,
                    csize, 0.f);
}

// 16-byte loads need c a multiple of W (4 floats, 8 bfloat16 values) and
// every (rows, c) pointer aligned.
inline bool bn_vectorized(int c, int w, const void* a, const void* b,
                          const void* d) {
  const unsigned long long bits = (unsigned long long)a |
                                  (unsigned long long)b |
                                  (unsigned long long)d;
  return c % w == 0 && (bits & 15ULL) == 0;
}

// What a call takes: rows and c at least 1, at most kSlotTickets column
// tiles (grid.y), a slot of the tickets.
inline bool bn_shape_ok(long long rows, int c, int v, int slot) {
  return rows > 0 && c > 0 && cdiv(c, kBnLanes * v) <= kSlotTickets &&
         slot >= 0 && slot < kTicketSlots;
}

// Values a 16-byte unit of E holds.
template <class E> constexpr int kVec = 16 / (int)sizeof(E);

// "base<v, relu>" at float32, "base<v, relu, __nv_bfloat16>" at bfloat16:
// the kernel's name in the library's launch counts.
inline std::string kernel_name(const char* base, int v, bool relu,
                               const float*) {
  return template_name(base, v, relu);
}
inline std::string kernel_name(const char* base, int v, bool relu,
                               const bf16*) {
  std::string s = template_name(base, v, relu);
  return s.insert(s.size() - 1, ", __nv_bfloat16");
}

// One instance of the kernels: its function, the clusters the card holds
// (read once), its plan at (rows, c).
template <int V, bool RELU, class E, bool BWD>
struct BnKernel {
  static const void* fn() {
    return BWD ? (const void*)bn_stats_bwd_kernel<V, RELU, E>
               : (const void*)bn_stats_fwd_kernel<V, RELU, E>;
  }
  static int resident() {
    static const int n = query_resident(fn(), dim3(kBnLanes, kBnWarps),
                                        kBnMaxCluster, 0, kBnBlocksPerSm);
    return n;
  }
  static BnPlan plan(long long rows, int c) {
    return bn_plan(rows, c, V, resident(), sm_count());
  }
};

// One launch of `kernel` on the plan's grid and clusters.
template <class... P, class... A>
cudaError_t bn_launch(void (*kernel)(P...), const BnPlan& p, cudaStream_t st,
                      A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.chunks, (unsigned)p.tiles);
  cfg.blockDim = dim3(kBnLanes, kBnWarps);
  cfg.stream = st;
  cudaLaunchAttribute attr = cluster_attr(p.csize);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int V, bool RELU, class E>
cudaError_t fwd_launch(const E* x, const float* scale, const float* bias,
                       const float* mean, const float* var, E* y,
                       float* stats, float* scratch, long long rows, int c,
                       float eps, int slot, cudaStream_t st) {
  const BnPlan p = BnKernel<V, RELU, E, false>::plan(rows, c);
  return bn_launch(bn_stats_fwd_kernel<V, RELU, E>, p, st, x, scale, bias,
                   mean, var, y, stats, scratch, slot, rows, p.chunk, c,
                   p.csize, eps);
}

template <int V, bool RELU, class E>
cudaError_t bwd_launch(const E* x, const float* scale, const float* bias,
                       const float* mean, const float* var, const float* m,
                       const E* g_y, const float* g_m, const float* g_v,
                       E* dx, float* dsb, float* scratch, long long rows,
                       int c, float eps, int slot, cudaStream_t st) {
  const BnPlan p = BnKernel<V, RELU, E, true>::plan(rows, c);
  return bn_launch(bn_stats_bwd_kernel<V, RELU, E>, p, st, x, scale, bias,
                   mean, var, m, g_y, g_m, g_v, dx, dsb, scratch, slot, rows,
                   p.chunk, c, p.csize, eps);
}

// The forward: one launch.
template <class E>
int bn_fwd(const E* x, const float* scale, const float* bias,
           const float* mean, const float* var, E* y, float* stats,
           float* scratch, long long rows, int c, float eps, int relu,
           int slot, cudaStream_t st) {
  constexpr int W = kVec<E>;
  const int v = bn_vectorized(c, W, x, y, nullptr) ? W : 1;
  if (!bn_shape_ok(rows, c, v, slot)) return (int)cudaErrorInvalidValue;
  const auto launch = v == W ? (relu ? fwd_launch<W, true, E>
                                     : fwd_launch<W, false, E>)
                             : (relu ? fwd_launch<1, true, E>
                                     : fwd_launch<1, false, E>);
  const cudaError_t e = launch(x, scale, bias, mean, var, y, stats, scratch,
                               rows, c, eps, slot, st);
  count_launch(kernel_name("bn_stats_fwd_kernel", v, relu != 0, x).c_str());
  return (int)e;
}

// The backward: one launch.
template <class E>
int bn_bwd(const E* x, const float* scale, const float* bias,
           const float* mean, const float* var, const float* m, const E* g_y,
           const float* g_m, const float* g_v, E* dx, float* dsb,
           float* scratch, long long rows, int c, float eps, int relu,
           int slot, cudaStream_t st) {
  constexpr int W = kVec<E>;
  const int v = bn_vectorized(c, W, x, g_y, dx) ? W : 1;
  if (!bn_shape_ok(rows, c, v, slot)) return (int)cudaErrorInvalidValue;
  const auto launch = v == W ? (relu ? bwd_launch<W, true, E>
                                     : bwd_launch<W, false, E>)
                             : (relu ? bwd_launch<1, true, E>
                                     : bwd_launch<1, false, E>);
  const cudaError_t e = launch(x, scale, bias, mean, var, m, g_y, g_m, g_v,
                               dx, dsb, scratch, rows, c, eps, slot, st);
  count_launch(kernel_name("bn_stats_bwd_kernel", v, relu != 0, x).c_str());
  return (int)e;
}

// The plan of the instance at v columns a thread (relu false; relu true has
// the same registers) and the clusters it was made for.
template <class E, bool BWD>
BnPlan bn_plan_of(long long rows, int c, int v, int* resident) {
  using K = BnKernel<kVec<E>, false, E, BWD>;
  using K1 = BnKernel<1, false, E, BWD>;
  *resident = v == 1 ? K1::resident() : K::resident();
  return v == 1 ? K1::plan(rows, c) : K::plan(rows, c);
}

// Floats of scratch a call of either direction at type E needs at (rows,
// c), whichever units its pointers allow.
template <class E>
long long bn_scratch_floats(long long rows, int c) {
  long long most = 0;
  for (const BnPlan& p :
       {BnKernel<1, false, E, false>::plan(rows, c),
        BnKernel<1, true, E, false>::plan(rows, c),
        BnKernel<kVec<E>, false, E, false>::plan(rows, c),
        BnKernel<kVec<E>, true, E, false>::plan(rows, c),
        BnKernel<1, false, E, true>::plan(rows, c),
        BnKernel<1, true, E, true>::plan(rows, c),
        BnKernel<kVec<E>, false, E, true>::plan(rows, c),
        BnKernel<kVec<E>, true, E, true>::plan(rows, c)})
    if (bn_partial_floats(p, c) > most) most = bn_partial_floats(p, c);
  return most;
}

}  // namespace vitta

extern "C" {

// Floats of scratch a call of either direction needs at (rows, c) with x
// float32 (bf16 0) or bfloat16 (bf16 1): the partials.
long long vitta_bn_stats_scratch_floats(long long rows, int c, int bf16) {
  return bf16 ? vitta::bn_scratch_floats<vitta::bf16>(rows, c)
              : vitta::bn_scratch_floats<float>(rows, c);
}

// The plan of a call at (rows, c), v columns a thread, x float32 (bf16 0)
// or bfloat16 (bf16 1), forward (bwd 0) or backward: out = tiles, csize,
// chunk, chunks, and what it was made for: the clusters of 8 blocks of the
// kernel the card holds at once, the card's SMs.
void vitta_bn_stats_plan(long long rows, int c, int v, int bf16, int bwd,
                         long long* out) {
  int resident = 0;
  const vitta::BnPlan p =
      bf16 ? (bwd ? vitta::bn_plan_of<vitta::bf16, true>(rows, c, v, &resident)
                  : vitta::bn_plan_of<vitta::bf16, false>(rows, c, v, &resident))
           : (bwd ? vitta::bn_plan_of<float, true>(rows, c, v, &resident)
                  : vitta::bn_plan_of<float, false>(rows, c, v, &resident));
  out[0] = p.tiles;
  out[1] = p.csize;
  out[2] = p.chunk;
  out[3] = p.chunks;
  out[4] = resident;
  out[5] = vitta::sm_count();
}

// Streams a device may run the kernels on at once, each with its own
// slot of tickets in 0 .. slots - 1.
int vitta_bn_stats_slots() { return vitta::kTicketSlots; }

// y (rows, c); stats (2, c) = m then v.  One launch.
int vitta_bn_stats_fwd(const float* x, const float* scale, const float* bias,
                       const float* mean, const float* var, float* y,
                       float* stats, float* scratch, long long rows, int c,
                       float eps, int relu, int slot, void* stream) {
  return vitta::bn_fwd(x, scale, bias, mean, var, y, stats, scratch, rows, c,
                       eps, relu, slot, (cudaStream_t)stream);
}

// dx (rows, c); dsb (2, c) = dscale then dbias.  g_y, g_m, g_v may be null.
// One launch.
int vitta_bn_stats_bwd(const float* x, const float* scale, const float* bias,
                       const float* mean, const float* var, const float* m,
                       const float* g_y, const float* g_m, const float* g_v,
                       float* dx, float* dsb, float* scratch, long long rows,
                       int c, float eps, int relu, int slot, void* stream) {
  return vitta::bn_bwd(x, scale, bias, mean, var, m, g_y, g_m, g_v, dx, dsb,
                       scratch, rows, c, eps, relu, slot,
                       (cudaStream_t)stream);
}

// The same at bfloat16: x, y, g_y and dx bfloat16, everything else float32.
int vitta_bn_stats_fwd_bf16(const void* x, const float* scale,
                            const float* bias, const float* mean,
                            const float* var, void* y, float* stats,
                            float* scratch, long long rows, int c, float eps,
                            int relu, int slot, void* stream) {
  return vitta::bn_fwd(reinterpret_cast<const vitta::bf16*>(x), scale, bias,
                       mean, var, reinterpret_cast<vitta::bf16*>(y), stats,
                       scratch, rows, c, eps, relu, slot,
                       (cudaStream_t)stream);
}

int vitta_bn_stats_bwd_bf16(const void* x, const float* scale,
                            const float* bias, const float* mean,
                            const float* var, const float* m, const void* g_y,
                            const float* g_m, const float* g_v, void* dx,
                            float* dsb, float* scratch, long long rows, int c,
                            float eps, int relu, int slot, void* stream) {
  return vitta::bn_bwd(reinterpret_cast<const vitta::bf16*>(x), scale, bias,
                       mean, var, m, reinterpret_cast<const vitta::bf16*>(g_y),
                       g_m, g_v, reinterpret_cast<vitta::bf16*>(dx), dsb,
                       scratch, rows, c, eps, relu, slot,
                       (cudaStream_t)stream);
}

}  // extern "C"
