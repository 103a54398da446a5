// Row LayerNorm device code shared by ln.cu (the standalone LayerNorm) and
// mlp.cu (the prologue of the fused LayerNorm->MLP).
//
//   y = (x - mu) * rsqrt(E[x^2] - mu^2 + eps) * gamma + beta     per row
//
// One warp owns one row.  The row is read once, kept in registers while
// two shuffle reductions produce sum and sum of squares, and written once:
// the work is bound by bytes (one read and one write of the activation),
// so nothing else may touch device memory.  The vector form takes
// C == 128 * VEC (every Swin-B width); the generic form takes any C and
// reads the row a second time, which the L1 cache serves.

#pragma once
#include <cuda_runtime.h>

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

}  // namespace vitta
