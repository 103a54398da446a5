// Swin relative-position-bias expansion for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of vitta_tpu/ops/pallas_bias.py:
//   _expand_kernel (:59, launched by _assemble :81).
//
// What it computes: the dense (nh, N, N) bias, N = wd*hw, from the Toeplitz
// slices V (nh, 2wd-1, hw, hw):
//   B[h, d1*hw + i, d2*hw + j] = V[h, d1 - d2 + wd - 1, i, j]
// Pure data movement: the output equals the block concatenation bit for bit.
//
// What bounds it: bytes, almost all of them the write of B (V is (2wd-1)/wd^2
// of B's size and stays in cache).  One block writes one row of B; its
// threads walk the row's columns, so every warp store is one contiguous
// line, and the reads of V are contiguous within each hw-wide segment.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
expand_bias_kernel(const float* __restrict__ v, float* __restrict__ out,
                   int wd, int hw) {
  const int n = wd * hw;
  const int row = blockIdx.x;          // d1*hw + i
  const int h = blockIdx.y;
  const int d1 = row / hw, i = row - d1 * hw;
  const int a_dim = 2 * wd - 1;
  const float* vh = v + (size_t)h * a_dim * hw * hw;
  float* orow = out + ((size_t)h * n + row) * n;
  for (int col = threadIdx.x; col < n; col += kThreads) {
    const int d2 = col / hw, j = col - d2 * hw;
    orow[col] = vh[((size_t)(d1 - d2 + wd - 1) * hw + i) * hw + j];
  }
}

}  // namespace

extern "C" {

int vitta_bias_expand(const float* v, float* out, int nh, int wd, int hw,
                      void* stream) {
  if (nh <= 0 || wd <= 0 || hw <= 0 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(wd * hw, nh);
  expand_bias_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(v, out, wd,
                                                                  hw);
  return (int)cudaGetLastError();
}

}  // extern "C"
