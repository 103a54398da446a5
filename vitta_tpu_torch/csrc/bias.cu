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
// of B's size and stays in cache).  One block writes one row of B; its
// threads walk the row's columns, so every warp store is one contiguous
// line, and the reads of V are contiguous within each hw-wide segment.
//
// The collapse is the transpose of that arrangement: each element of dV is
// the sum of the elements of dB that were copied from it,
//   dV[h, a, i, j] = sum over d1 with 0 <= d1 - (a - wd + 1) < wd of
//                    dB[h, d1*hw + i, (d1 - (a - wd + 1))*hw + j],
// at most wd of them, added in the order of d1 as the TPU kernel and the
// plain version add them, so the three agree bit for bit.  Bound by bytes,
// the read of dB; one thread per element of dV, neighbouring threads on
// neighbouring j, so a warp reads hw-wide contiguous segments of dB.

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

__global__ void __launch_bounds__(kThreads)
collapse_bias_kernel(const float* __restrict__ db, float* __restrict__ dv,
                     int nh, int wd, int hw) {
  const int a_dim = 2 * wd - 1;
  const long long total = (long long)nh * a_dim * hw * hw;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % hw);
  const int i = (int)((idx / hw) % hw);
  const int a = (int)((idx / ((long long)hw * hw)) % a_dim);
  const int h = (int)(idx / ((long long)a_dim * hw * hw));
  const int n = wd * hw;
  const float* dbh = db + (size_t)h * n * n;
  float acc = 0.f;
  for (int d1 = 0; d1 < wd; ++d1) {
    const int d2 = d1 - (a - wd + 1);
    if (d2 < 0 || d2 >= wd) continue;
    acc += dbh[(size_t)(d1 * hw + i) * n + d2 * hw + j];
  }
  dv[idx] = acc;
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

int vitta_bias_collapse(const float* db, float* dv, int nh, int wd, int hw,
                        void* stream) {
  if (nh <= 0 || wd <= 0 || hw <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nh * (2 * wd - 1) * hw * hw;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  collapse_bias_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      db, dv, nh, wd, hw);
  return (int)cudaGetLastError();
}

}  // extern "C"
