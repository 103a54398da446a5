// Reductions across blocks, shared by the backward kernels (ln.cu, mlp.cu,
// attention.cu).
//
// The TPU kernels accumulate a sum over all rows (dgamma, dbeta, the weight
// and bias gradients) in one output block that a sequential grid revisits.
// A CUDA grid has no order, so every such sum is taken in two steps: each
// block writes one partial result, and reduce_partials adds the partials in
// a fixed order.  No float atomics: the result is the same from run to run
// and differs from a plain reduction only by the order of float32 additions.

#pragma once
#include <cuda_runtime.h>

namespace vitta {

constexpr int kReduceThreads = 256;
constexpr int kColLanes = 32;        // columns per block of a column sum
constexpr int kColWarps = 8;         // rows in flight per block
constexpr int kColChunk = 256;       // rows per block

// out[i] = partial[0][i] + partial[1][i] + ... + partial[P-1][i], i < L.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const float* __restrict__ partial,
                       float* __restrict__ out, int P, long long L) {
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= L) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[(long long)p * L + i];
  out[i] = s;
}

inline cudaError_t launch_reduce_partials(const float* partial, float* out,
                                          int P, long long L,
                                          cudaStream_t stream) {
  if (L <= 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((L + kReduceThreads - 1) / kReduceThreads);
  reduce_partials_kernel<<<blocks, kReduceThreads, 0, stream>>>(partial, out,
                                                                P, L);
  return cudaGetLastError();
}

inline int col_chunks(long long rows) {
  return (int)((rows + kColChunk - 1) / kColChunk);
}

// partial[chunk][col] = sum of x[r][col] over the chunk's rows, x (rows, c).
// grid (ceil(c / 32), chunks), block (32, 8): a warp reads 32 neighbouring
// columns of one row, the 8 warps walk the chunk's rows.
__global__ void __launch_bounds__(kColLanes * kColWarps)
col_sums_kernel(const float* __restrict__ x, float* __restrict__ partial,
                long long rows, int c) {
  __shared__ float part[kColWarps][kColLanes + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kColLanes + tx;
  const long long r0 = (long long)blockIdx.y * kColChunk;
  const long long r1 = r0 + kColChunk < rows ? r0 + kColChunk : rows;
  float s = 0.f;
  if (col < c)
    for (long long r = r0 + ty; r < r1; r += kColWarps) s += x[r * c + col];
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < c) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) t += part[w][tx];
    partial[(long long)blockIdx.y * c + col] = t;
  }
}

// out[col] = sum over all rows of x[r][col]; partial holds
// col_chunks(rows) * c floats.
inline cudaError_t launch_col_sums(const float* x, float* partial, float* out,
                                   long long rows, int c,
                                   cudaStream_t stream) {
  const int chunks = col_chunks(rows);
  const dim3 grid((c + kColLanes - 1) / kColLanes, chunks);
  const dim3 block(kColLanes, kColWarps);
  col_sums_kernel<<<grid, block, 0, stream>>>(x, partial, rows, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_reduce_partials(partial, out, chunks, c, stream);
}

}  // namespace vitta
