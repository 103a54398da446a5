// Reductions across blocks, shared by the backward kernels (ln.cu, mlp.cu,
// attention.cu, attention_proj.cu).
//
// The TPU kernels accumulate a sum over all rows (dgamma, dbeta, the weight
// and bias gradients) in one output block that a sequential grid revisits.
// A CUDA grid has no order, so every such sum is taken in two steps: each
// block writes one partial result, and reduce_partials adds the partials in
// a fixed order.  No float atomics: the result is the same from run to run
// and differs from a plain reduction only by the order of float32 additions.
// An output's partials are added one after the other, in partial order.
// Where they are few, a thread takes one output and reads them one by one.
// Where they are many (kStagedCount or more: the LayerNorm backward's and
// the BatchNorm statistics' one partial per block, the weight gradients of
// the small products' many k-chunks), that would leave a thread waiting
// out the L2 cache's latency once for each: there a block of kSumThreads
// threads takes 32 neighbouring outputs and copies up to kStageRows of
// their partials at once into shared memory, every copy in flight together
// (cp.async), and one warp adds them, a lane an output, in the same order.
// Both forms give the same bits.  The sums are float32; an output may be
// bfloat16 (the bfloat16 weight and bias gradients), rounded once.

#pragma once
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "launches.cuh"
#include "tf32.cuh"

namespace vitta {

constexpr int kReduceThreads = 256;
constexpr int kColLanes = 32;        // columns per block of a column sum
constexpr int kColWarps = 8;         // rows in flight per block
constexpr int kColChunk = 256;       // rows per block
constexpr int kSumThreads = 256;     // a block of reduce_partials / _sums
constexpr int kStagedCount = 32;     // partials from which a sum is staged
constexpr int kStageRows = 128;      // partials staged at once

// Outputs a block of a sum of `count` partials takes.
__host__ __device__ inline int sum_outputs_per_block(int count) {
  return count >= kStagedCount ? 32 : kSumThreads;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The staging tile of a staged sum, the kernel's own: one a block, whatever
// the type of the sums' outputs.
using SumTile = float[kStageRows][33];

// out[i] = partial[i] + partial[stride + i] + ... + partial[(count - 1) *
// stride + i], added in that order, for the block's outputs i from i0 (one
// a thread, or 32 staged in `tile`; sum_outputs_per_block).  Every thread
// of the block calls it.
template <class TOut>
__device__ __forceinline__ void ordered_sums(const float* __restrict__ partial,
                                             TOut* __restrict__ out,
                                             int count, long long stride,
                                             long long i0, long long len,
                                             SumTile& tile) {
  if (count < kStagedCount) {
    const long long i = i0 + threadIdx.x;
    if (i >= len) return;
    float s = 0.f;
    for (int p = 0; p < count; ++p) s += partial[p * stride + i];
    put(out + i, s);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i = i0 + lane;
  const bool ok = i < len;
  float s = 0.f;
  for (int p0 = 0; p0 < count; p0 += kStageRows) {
    const int rows = count - p0 < kStageRows ? count - p0 : kStageRows;
    for (int r = warp; r < rows; r += kSumThreads / 32)
      cp_async<4>(&tile[r][lane], partial + (p0 + r) * stride + (ok ? i : 0),
                  ok);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (warp == 0)
      for (int r = 0; r < rows; ++r) s += tile[r][lane];
    __syncthreads();
  }
  if (warp == 0 && ok) put(out + i, s);
}

// out[i] = partial[0][i] + partial[1][i] + ... + partial[P-1][i], i < L.
template <class TOut>
__global__ void __launch_bounds__(kSumThreads)
reduce_partials_kernel(const float* __restrict__ partial,
                       TOut* __restrict__ out, int P, long long L) {
  __shared__ SumTile tile;
  ordered_sums(partial, out, P, L,
               (long long)blockIdx.x * sum_outputs_per_block(P), L, tile);
}

template <class TOut>
inline cudaError_t launch_reduce_partials(const float* partial, TOut* out,
                                          int P, long long L,
                                          cudaStream_t stream) {
  if (L <= 0) return cudaSuccess;
  const int per = sum_outputs_per_block(P);
  const unsigned blocks = (unsigned)((L + per - 1) / per);
  reduce_partials_kernel<TOut><<<blocks, kSumThreads, 0, stream>>>(
      partial, out, P, L);
  count_launch(sizeof(TOut) == 4 ? "reduce_partials_kernel"
                                 : "reduce_partials_kernel<__nv_bfloat16>");
  return cudaGetLastError();
}

// Several such sums in one launch, for a chain that leaves the partials of
// a few outputs behind (attention_proj.cu's backward: the two weight
// gradients, their biases, dgamma and dbeta).  Sum j adds count partials,
// stride floats apart, of len floats each: out[i] = partial[0 * stride +
// i] + ... + partial[(count - 1) * stride + i], in that order, as
// reduce_partials adds them; its blocks are first[j] .. first[j + 1] - 1.
// Its output is float32 (out) or bfloat16 (outb, rounded once).
constexpr int kMaxPartialSums = 6;

struct PartialSum {
  const float* partial;
  float* out;
  long long stride, len;
  int count;
  bf16* outb;
};

struct PartialSums {
  PartialSum sum[kMaxPartialSums];
  int first[kMaxPartialSums + 1];
  int n = 0;

  // an output that is null is not wanted and is skipped
  bool add(const float* partial, long long stride, float* out, int count,
           long long len) {
    return add_to(partial, stride, out, nullptr, count, len);
  }
  bool add(const float* partial, long long stride, bf16* out, int count,
           long long len) {
    return add_to(partial, stride, nullptr, out, count, len);
  }

 private:
  bool add_to(const float* partial, long long stride, float* out, bf16* outb,
              int count, long long len) {
    if ((out == nullptr && outb == nullptr) || len <= 0) return true;
    if (n == kMaxPartialSums) return false;
    sum[n] = PartialSum{partial, out, stride, len, count, outb};
    const int per = sum_outputs_per_block(count);
    first[0] = 0;
    first[n + 1] = first[n] + (int)((len + per - 1) / per);
    ++n;
    return true;
  }
};

__global__ void __launch_bounds__(kSumThreads)
reduce_sums_kernel(const PartialSums sums) {
  int j = 0;
  while (j + 1 < sums.n && (int)blockIdx.x >= sums.first[j + 1]) ++j;
  const PartialSum s = sums.sum[j];
  __shared__ SumTile tile;
  const long long i0 = (long long)(blockIdx.x - sums.first[j]) *
                       sum_outputs_per_block(s.count);
  if (s.outb != nullptr)
    ordered_sums(s.partial, s.outb, s.count, s.stride, i0, s.len, tile);
  else
    ordered_sums(s.partial, s.out, s.count, s.stride, i0, s.len, tile);
}

inline cudaError_t launch_reduce_sums(const PartialSums& sums,
                                      cudaStream_t stream) {
  if (sums.n == 0) return cudaSuccess;
  reduce_sums_kernel<<<sums.first[sums.n], kSumThreads, 0, stream>>>(sums);
  count_launch("reduce_sums_kernel");
  return cudaGetLastError();
}

inline int col_chunks(long long rows) {
  return (int)((rows + kColChunk - 1) / kColChunk);
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v) {
  return __bfloat162float(v);
}

// partial[chunk][col] = sum of x[r][col] over the chunk's rows, x (rows, c)
// float32 or bfloat16, the sums float32.  grid (ceil(c / 32), chunks),
// block (32, 8): a warp reads 32 neighbouring columns of one row, the 8
// warps walk the chunk's rows.
template <class TIn>
__device__ __forceinline__ void col_sums_block(const TIn* __restrict__ x,
                                               float* __restrict__ partial,
                                               long long rows, int c,
                                               int bx) {
  __shared__ float part[kColWarps][kColLanes + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = bx * kColLanes + tx;
  const long long r0 = (long long)blockIdx.y * kColChunk;
  const long long r1 = r0 + kColChunk < rows ? r0 + kColChunk : rows;
  float s = 0.f;
  if (col < c)
    for (long long r = r0 + ty; r < r1; r += kColWarps)
      s += as_float(x[r * c + col]);
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < c) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) t += part[w][tx];
    partial[(long long)blockIdx.y * c + col] = t;
  }
}

template <class TIn>
__global__ void __launch_bounds__(kColLanes * kColWarps)
col_sums_kernel(const TIn* __restrict__ x, float* __restrict__ partial,
                long long rows, int c) {
  col_sums_block(x, partial, rows, c, blockIdx.x);
}

// The column partials of two matrices of `rows` rows in one launch, as
// col_sums_kernel makes each: blocks 0 .. nb1 - 1 of grid.x take x1's
// columns (c1 of them), the others x2's (c2).
template <class TIn>
__global__ void __launch_bounds__(kColLanes * kColWarps)
col_sums2_kernel(const TIn* __restrict__ x1, float* __restrict__ p1, int c1,
                 const TIn* __restrict__ x2, float* __restrict__ p2, int c2,
                 long long rows, int nb1) {
  if ((int)blockIdx.x < nb1)
    col_sums_block(x1, p1, rows, c1, blockIdx.x);
  else
    col_sums_block(x2, p2, rows, c2, blockIdx.x - nb1);
}

// out[col] = sum over all rows of x[r][col]; partial holds
// col_chunks(rows) * c floats.  out is rounded once where it is bfloat16.
template <class TIn, class TOut>
inline cudaError_t launch_col_sums(const TIn* x, float* partial, TOut* out,
                                   long long rows, int c,
                                   cudaStream_t stream) {
  const int chunks = col_chunks(rows);
  const dim3 grid((c + kColLanes - 1) / kColLanes, chunks);
  const dim3 block(kColLanes, kColWarps);
  col_sums_kernel<TIn><<<grid, block, 0, stream>>>(x, partial, rows, c);
  count_launch(sizeof(TIn) == 4 ? "col_sums_kernel"
                                : "col_sums_kernel<__nv_bfloat16>");
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_reduce_partials(partial, out, chunks, c, stream);
}

// The column partials of x1 (rows, c1) into p1 and of x2 (rows, c2) into
// p2, col_chunks(rows) rows of c1 or c2 floats each, in one launch; x2
// may be null (then x1's alone).  A reduce (reduce_partials, or a chain's
// reduce_sums) adds each one's rows in order.
template <class TIn>
inline cudaError_t launch_col_partials2(const TIn* x1, float* p1, int c1,
                                        const TIn* x2, float* p2, int c2,
                                        long long rows, cudaStream_t stream) {
  const int nb1 = (c1 + kColLanes - 1) / kColLanes;
  const int nb2 = x2 != nullptr ? (c2 + kColLanes - 1) / kColLanes : 0;
  const dim3 grid(nb1 + nb2, col_chunks(rows));
  const dim3 block(kColLanes, kColWarps);
  col_sums2_kernel<TIn><<<grid, block, 0, stream>>>(x1, p1, c1, x2, p2, c2,
                                                    rows, nb1);
  count_launch(sizeof(TIn) == 4 ? "col_sums2_kernel"
                                : "col_sums2_kernel<__nv_bfloat16>");
  return cudaGetLastError();
}

}  // namespace vitta
