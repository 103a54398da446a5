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
// reads the row a second time, which the L1 cache serves.

//
// Backward, from (x, gamma, dy), with xh = (x - mu) * rstd recomputed and
// wg = dy * gamma:
//   dx     = rstd * (wg - mean(wg) - xh * mean(wg * xh))         per row
//   dgamma = sum over rows of dy * xh,   dbeta = sum over rows of dy
// dx is one warp per row again (x and dy read once, dx written once, the
// row's mu and rstd kept in a (rows, 2) scratch).  dgamma and dbeta are sums
// over all rows: a second kernel walks columns (a warp on 32 neighbouring
// columns, 8 warps over a chunk of 256 rows), recomputes xh from the kept
// statistics and writes one partial (2, C) per chunk; reduce_partials
// (reduce.cuh) adds the chunks in order.  That reads x and dy a second time
// (5 passes over the activation where 3 are the least possible); at the
// Swin-B shapes the second read comes from the L2 cache.

#pragma once
#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(kLnThreads)
ln_rows_any(const float* __restrict__ x, const float* __restrict__ gamma,
            const float* __restrict__ beta, float* __restrict__ y,
            long long rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kLnRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * c;
  float s = 0.f, sq = 0.f;
  for (int j = lane; j < c; j += 32) {
    const float v = xr[j];
    s += v;
    sq += v * v;
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  const float mu = s / c;
  const float rstd = rsqrtf(sq / c - mu * mu + eps);
  float* yr = y + row * c;
  for (int j = lane; j < c; j += 32)
    yr[j] = (xr[j] - mu) * rstd * gamma[j] + beta[j];
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
    break;
  switch (c) {
    VITTA_LN_CASE(1)
    VITTA_LN_CASE(2)
    VITTA_LN_CASE(4)
    VITTA_LN_CASE(8)
    VITTA_LN_CASE(16)
    default:
      ln_rows_any<<<blocks, kLnThreads, 0, stream>>>(x, gamma, beta, y, rows,
                                                     c, eps);
  }
#undef VITTA_LN_CASE
  return cudaGetLastError();
}

// ---------------------------------------------------------------- backward

template <int VEC>
__global__ void __launch_bounds__(kLnThreads)
ln_bwd_rows_vec(const float* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ dy, float* __restrict__ dx,
                float* __restrict__ stats, long long rows, float eps) {
  constexpr int C = 128 * VEC;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kLnRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float4* xr = reinterpret_cast<const float4*>(x + row * C);
  const float4* dr = reinterpret_cast<const float4*>(dy + row * C);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  float4 v[VEC], w[VEC];
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    v[i] = xr[lane + 32 * i];
    w[i] = dr[lane + 32 * i];
    s += v[i].x + v[i].y + v[i].z + v[i].w;
    sq += v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z + v[i].w * v[i].w;
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  const float mu = s * (1.0f / C);
  const float rstd = rsqrtf(sq * (1.0f / C) - mu * mu + eps);
  float a = 0.f, b = 0.f;      // sums of wg and of wg * xh
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float4 g = g4[lane + 32 * i];
    v[i].x = (v[i].x - mu) * rstd, w[i].x *= g.x;
    v[i].y = (v[i].y - mu) * rstd, w[i].y *= g.y;
    v[i].z = (v[i].z - mu) * rstd, w[i].z *= g.z;
    v[i].w = (v[i].w - mu) * rstd, w[i].w *= g.w;
    a += w[i].x + w[i].y + w[i].z + w[i].w;
    b += w[i].x * v[i].x + w[i].y * v[i].y + w[i].z * v[i].z + w[i].w * v[i].w;
  }
  a = warp_sum(a) * (1.0f / C);
  b = warp_sum(b) * (1.0f / C);
  float4* or_ = reinterpret_cast<float4*>(dx + row * C);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float4 o;
    o.x = rstd * (w[i].x - a - v[i].x * b);
    o.y = rstd * (w[i].y - a - v[i].y * b);
    o.z = rstd * (w[i].z - a - v[i].z * b);
    o.w = rstd * (w[i].w - a - v[i].w * b);
    or_[lane + 32 * i] = o;
  }
  if (lane == 0) {
    stats[2 * row] = mu;
    stats[2 * row + 1] = rstd;
  }
}

__global__ void __launch_bounds__(kLnThreads)
ln_bwd_rows_any(const float* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ dy, float* __restrict__ dx,
                float* __restrict__ stats, long long rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kLnRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * c;
  const float* dr = dy + row * c;
  float s = 0.f, sq = 0.f;
  for (int j = lane; j < c; j += 32) {
    const float v = xr[j];
    s += v;
    sq += v * v;
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  const float mu = s / c;
  const float rstd = rsqrtf(sq / c - mu * mu + eps);
  float a = 0.f, b = 0.f;
  for (int j = lane; j < c; j += 32) {
    const float wg = dr[j] * gamma[j];
    a += wg;
    b += wg * (xr[j] - mu) * rstd;
  }
  a = warp_sum(a) / c;
  b = warp_sum(b) / c;
  float* or_ = dx + row * c;
  for (int j = lane; j < c; j += 32)
    or_[j] = rstd * (dr[j] * gamma[j] - a - (xr[j] - mu) * rstd * b);
  if (lane == 0) {
    stats[2 * row] = mu;
    stats[2 * row + 1] = rstd;
  }
}

// partial[chunk][0][col] = sum of dy * xh, partial[chunk][1][col] = sum of dy
// over the chunk's rows.  grid (ceil(c / 32), chunks), block (32, 8).
__global__ void __launch_bounds__(kColLanes * kColWarps)
ln_bwd_cols(const float* __restrict__ x, const float* __restrict__ dy,
            const float* __restrict__ stats, float* __restrict__ partial,
            long long rows, int c) {
  __shared__ float pg[kColWarps][kColLanes + 1];
  __shared__ float pb[kColWarps][kColLanes + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kColLanes + tx;
  const long long r0 = (long long)blockIdx.y * kColChunk;
  const long long r1 = r0 + kColChunk < rows ? r0 + kColChunk : rows;
  float ag = 0.f, ab = 0.f;
  if (col < c)
    for (long long r = r0 + ty; r < r1; r += kColWarps) {
      const float d = dy[r * c + col];
      ag += d * (x[r * c + col] - stats[2 * r]) * stats[2 * r + 1];
      ab += d;
    }
  pg[ty][tx] = ag;
  pb[ty][tx] = ab;
  __syncthreads();
  if (ty == 0 && col < c) {
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) {
      tg += pg[w][tx];
      tb += pb[w][tx];
    }
    float* p = partial + (long long)blockIdx.y * 2 * c;
    p[col] = tg;
    p[c + col] = tb;
  }
}

// Floats of scratch the backward needs: the rows' (mu, rstd) and one
// partial (2, c) per chunk of rows.
inline long long ln_bwd_scratch_floats(long long rows, int c) {
  return 2 * rows + (long long)col_chunks(rows) * 2 * c;
}

// Launch the LayerNorm backward on `stream`: dx (rows, c), dgb (2, c) =
// (dgamma, dbeta); scratch as ln_bwd_scratch_floats says.  Returns the first
// launch error.
inline cudaError_t launch_ln_bwd(const float* x, const float* gamma,
                                 const float* dy, float* dx, float* dgb,
                                 float* scratch, long long rows, int c,
                                 float eps, cudaStream_t stream) {
  if (rows <= 0) return cudaErrorInvalidValue;
  float* stats = scratch;
  float* partial = scratch + 2 * rows;
  const unsigned blocks =
      (unsigned)((rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock);
#define VITTA_LN_BWD_CASE(V)                                                 \
  case 128 * V:                                                              \
    ln_bwd_rows_vec<V><<<blocks, kLnThreads, 0, stream>>>(x, gamma, dy, dx,  \
                                                          stats, rows, eps); \
    break;
  switch (c) {
    VITTA_LN_BWD_CASE(1)
    VITTA_LN_BWD_CASE(2)
    VITTA_LN_BWD_CASE(4)
    VITTA_LN_BWD_CASE(8)
    VITTA_LN_BWD_CASE(16)
    default:
      ln_bwd_rows_any<<<blocks, kLnThreads, 0, stream>>>(x, gamma, dy, dx,
                                                         stats, rows, c, eps);
  }
#undef VITTA_LN_BWD_CASE
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int chunks = col_chunks(rows);
  const dim3 grid((c + kColLanes - 1) / kColLanes, chunks);
  const dim3 block(kColLanes, kColWarps);
  ln_bwd_cols<<<grid, block, 0, stream>>>(x, dy, stats, partial, rows, c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_reduce_partials(partial, dgb, chunks, 2LL * c, stream);
}

}  // namespace vitta
