// Swin relative-position-bias expansion and its backward, the collapse, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vitta_tpu/ops/pallas_bias.py:
//   _expand_kernel (:59, launched by _assemble :81) and
//   _collapse_kernel (:67, launched by _assemble_bwd :101).
//
// What it computes: the dense (nh, N, N) bias, N = wd*hw, from the Toeplitz
// slices V (nh, 2wd-1, hw, hw):
//   B[h, d1*hw + i, d2*hw + j] = V[h, d1 - d2 + wd - 1, i, j]
// Pure data movement: the output equals the block concatenation bit for bit.
//
// What bounds it: bytes, almost all of them the write of B (V is (2wd-1)/wd^2
// of B's size).  A block per (head h, in-frame row i) writes the wd rows
// d1*hw + i of B.  Each of them draws on the same 2wd-1 rows V[h, a, i, :],
// so the block reads those once into shared memory, in reverse order of a:
//   r[b*hw + j] = V[h, 2wd-2-b, i, j],
// and row d1*hw + i of B is then the contiguous run r[(wd-1-d1)*hw ...] of
// N floats: a copy, with no index arithmetic per element.  Where N % 4 == 0
// every row of B starts 16-byte aligned (its offset is a multiple of N),
// and the block keeps four copies of r, copy s shifted by s floats, so that
// each run starts aligned in one of them: every thread moves 16 bytes with
// one shared-memory load and one store.  Otherwise the rows go out float by
// float from the one copy.  Where the copies do not fit in shared memory
// (2wd-1 rows of hw floats beyond 227 KB), the block reads V where it lies,
// walking each row's wd segments with running indices.
//
// The collapse is the transpose of that arrangement: each element of dV is
// the sum of the elements of dB that were copied from it,
//   dV[h, a, i, j] = sum over d1 with 0 <= d1 - (a - wd + 1) < wd of
//                    dB[h, d1*hw + i, (d1 - (a - wd + 1))*hw + j],
// at most wd of them, added in the order of d1 as the TPU kernel and the
// plain version add them, so the three agree bit for bit.  Bound by bytes,
// the read of dB.  A block per (head h, in-frame row i), grid (hw, nh) as
// the expansion's, needs exactly the wd whole rows d1*hw + i of dB: it
// copies them into shared memory, st[d1*N + col], every copy in flight
// before any is used (cp.async, 16 bytes a copy where N % 4 == 0 and dB is
// 16-byte aligned, so that every row starts aligned; one float otherwise),
// then makes dV[h, a, i, :] for the 2wd-1 values of a, each element the
// sum over d1 of st[d1*N + (d1 - a + wd - 1)*hw + j], with running indices
// and no division.  Where the rows do not fit in shared memory (wd*N floats
// beyond 227 KB), the block reads them from dB where they lie, in the same
// order.

#include <cuda_runtime.h>

#include <cstdint>

#include "launches.cuh"
#include "tf32.cuh"

namespace {

using vitta::count_launch;

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 227 * 1024;   // a block's shared memory on Hopper

// Steps a running (segment, offset) pair forward by `step` elements of
// segments `len` long: a division's work only where step > len.
__device__ __forceinline__ void advance(int& seg, int& off, int step,
                                        int len) {
  off += step;
  while (off >= len) {
    off -= len;
    ++seg;
  }
}

// grid (hw, nh): block (i, h) writes rows d1*hw + i of head h.  VEC: N % 4
// == 0, four shifted copies of r `pitch` floats apart; else one copy.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
expand_bias_staged(const float* __restrict__ v, float* __restrict__ out,
                   int wd, int hw, int pitch) {
  extern __shared__ __align__(16) float st[];
  const int i = blockIdx.x, h = blockIdx.y;
  const int a_dim = 2 * wd - 1, n = wd * hw;
  const float* vi = v + ((size_t)h * a_dim * hw + i) * hw;   // V[h, 0, i, :]
  for (int b = threadIdx.x >> 5; b < a_dim; b += kThreads / 32) {
    const float* src = vi + (size_t)(a_dim - 1 - b) * hw * hw;
    for (int j = threadIdx.x & 31; j < hw; j += 32) {
      const float val = src[j];
      const int k = b * hw + j;
      if (VEC) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (k >= s) st[s * pitch + k - s] = val;
      } else {
        st[k] = val;
      }
    }
  }
  __syncthreads();
  float* rows = out + ((size_t)h * n + i) * n;   // row d1*hw + i: + d1*hw*n
  const int len = VEC ? n / 4 : n;                // a row, in moves
  int d1 = 0, q = 0;
  advance(d1, q, threadIdx.x, len);
  while (d1 < wd) {
    const int o = (wd - 1 - d1) * hw;             // the row's run in r
    float* dst = rows + (size_t)d1 * hw * n;
    if (VEC) {
      const float4* src =
          reinterpret_cast<const float4*>(st + (o & 3) * pitch) + (o >> 2);
      reinterpret_cast<float4*>(dst)[q] = src[q];
    } else {
      dst[q] = st[o + q];
    }
    advance(d1, q, kThreads, len);
  }
}

// The same rows read from V where it lies, for windows whose rows r do not
// fit in shared memory.
__global__ void __launch_bounds__(kThreads)
expand_bias_direct(const float* __restrict__ v, float* __restrict__ out,
                   int wd, int hw) {
  const int i = blockIdx.x, h = blockIdx.y;
  const int a_dim = 2 * wd - 1, n = wd * hw;
  const float* vi = v + ((size_t)h * a_dim * hw + i) * hw;
  for (int d1 = 0; d1 < wd; ++d1) {
    float* dst = out + ((size_t)h * n + d1 * hw + i) * n;
    int d2 = 0, j = 0;
    advance(d2, j, threadIdx.x, hw);
    while (d2 < wd) {
      dst[d2 * hw + j] = vi[(size_t)(d1 - d2 + wd - 1) * hw * hw + j];
      advance(d2, j, kThreads, hw);
    }
  }
}

// grid (hw, nh): block (i, h) makes dV[h, a, i, :] for every a from rows
// d1*hw + i of dB[h], staged in shared memory.  VEC: 16-byte copies.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
collapse_bias_staged(const float* __restrict__ db, float* __restrict__ dv,
                     int wd, int hw) {
  extern __shared__ __align__(16) float st[];
  const int i = blockIdx.x, h = blockIdx.y;
  const int a_dim = 2 * wd - 1, n = wd * hw;
  const float* rows = db + ((size_t)h * n + i) * n;   // row d1*hw + i: + d1*hw*n
  const int len = VEC ? n / 4 : n;                    // a row, in copies
  int d1 = 0, q = 0;
  advance(d1, q, threadIdx.x, len);
  while (d1 < wd) {
    const float* src = rows + (size_t)d1 * hw * n;
    if (VEC)
      vitta::cp_async<16>(st + d1 * n + 4 * q, src + 4 * q, true);
    else
      vitta::cp_async<4>(st + d1 * n + q, src + q, true);
    advance(d1, q, kThreads, len);
  }
  vitta::cp_async_commit();
  vitta::cp_async_wait_all();
  __syncthreads();
  // dV[h, a, i, :] at out + a*hw*hw
  float* out = dv + ((size_t)h * a_dim * hw + i) * hw;
  int a = 0, j = 0;
  advance(a, j, threadIdx.x, hw);
  while (a < a_dim) {
    const int lo = a - wd + 1 > 0 ? a - wd + 1 : 0;   // d2 = d1 - a + wd - 1
    const int hi = a + 1 < wd ? a + 1 : wd;            // in [0, wd)
    const int at = (wd - 1 - a) * hw + j;              // + d1*(n + hw)
    float acc = st[at + lo * (n + hw)];
    for (int d = lo + 1; d < hi; ++d) acc += st[at + d * (n + hw)];
    out[(size_t)a * hw * hw + j] = acc;
    advance(a, j, kThreads, hw);
  }
}

// The same from dB where it lies, for windows whose wd rows do not fit in
// shared memory.
__global__ void __launch_bounds__(kThreads)
collapse_bias_direct(const float* __restrict__ db, float* __restrict__ dv,
                     int wd, int hw) {
  const int i = blockIdx.x, h = blockIdx.y;
  const int a_dim = 2 * wd - 1, n = wd * hw;
  const float* rows = db + ((size_t)h * n + i) * n;
  float* out = dv + ((size_t)h * a_dim * hw + i) * hw;
  int a = 0, j = 0;
  advance(a, j, threadIdx.x, hw);
  while (a < a_dim) {
    const int lo = a - wd + 1 > 0 ? a - wd + 1 : 0;
    const int hi = a + 1 < wd ? a + 1 : wd;
    const long long at = (wd - 1 - a) * hw + j;       // + d1*(hw*n + hw)
    const long long step = (long long)hw * n + hw;
    float acc = rows[at + lo * step];
    for (int d = lo + 1; d < hi; ++d) acc += rows[at + d * step];
    out[(size_t)a * hw * hw + j] = acc;
    advance(a, j, kThreads, hw);
  }
}

// One launch of a kernel of this file with `smem` bytes of dynamic shared
// memory (above the 48 KB default only after the opt-in), counted under
// `name`.
template <class K, class... Args>
int launch_counted(K kernel, const char* name, dim3 grid, size_t smem,
                   cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, s>>>(args...);
  count_launch(name);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int vitta_bias_expand(const float* v, float* out, int nh, int wd, int hw,
                      void* stream) {
  if (nh <= 0 || wd <= 0 || hw <= 0 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(hw, nh);
  cudaStream_t s = (cudaStream_t)stream;
  const int len = (2 * wd - 1) * hw;
  const int pitch = (len + 3) & ~3;
  const bool vec = (wd * hw) % 4 == 0;
  const size_t smem = (vec ? 4 * (size_t)pitch : (size_t)len) * sizeof(float);
  if (smem > kMaxSmem)
    return launch_counted(expand_bias_direct, "expand_bias_direct", grid, 0,
                          s, v, out, wd, hw);
  return vec ? launch_counted(expand_bias_staged<true>,
                              "expand_bias_staged<true>", grid, smem, s, v,
                              out, wd, hw, pitch)
             : launch_counted(expand_bias_staged<false>,
                              "expand_bias_staged<false>", grid, smem, s, v,
                              out, wd, hw, pitch);
}

int vitta_bias_collapse(const float* db, float* dv, int nh, int wd, int hw,
                        void* stream) {
  if (nh <= 0 || wd <= 0 || hw <= 0 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(hw, nh);
  cudaStream_t s = (cudaStream_t)stream;
  const int n = wd * hw;
  const size_t smem = (size_t)wd * n * sizeof(float);
  if (smem > kMaxSmem)
    return launch_counted(collapse_bias_direct, "collapse_bias_direct", grid,
                          0, s, db, dv, wd, hw);
  const bool vec =
      n % 4 == 0 && (reinterpret_cast<std::uintptr_t>(db) & 15) == 0;
  return vec ? launch_counted(collapse_bias_staged<true>,
                              "collapse_bias_staged<true>", grid, smem, s, db,
                              dv, wd, hw)
             : launch_counted(collapse_bias_staged<false>,
                              "collapse_bias_staged<false>", grid, smem, s,
                              db, dv, wd, hw);
}

}  // extern "C"
