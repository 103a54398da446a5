// Fused LayerNorm -> MLP, forward and backward, for Video Swin, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of vitta_tpu/ops/pallas_mlp.py:
//   _lnmlp_fwd_kernel (:303) and its pipelined form (:386), launched by
//   _pallas_lnmlp_fwd (:523), and
//   _lnmlp_bwd_kernel (:322) and its pipelined form (:438), launched by
//   _pallas_lnmlp_bwd (:560).
//
// What the forward computes, on x (M, C) with the weights in torch.nn.Linear
// layout (w1 (F, C), w2 (C, F)):
//   y = LayerNorm(x) * gamma + beta          one-pass float32 statistics
//   h = y w1^T + b1
//   a = h * Phi(h)                           exact GELU, erff
//   o = a w2^T + b2
// and returns o and y (the norm2 tap reads y); on request also a and
// s = Phi(h) + h * phi(h), the GELU derivative, which the backward reads.
//
// What the backward computes, from (x, y, a, s, go, gy, gamma, w1, w2) with
// go and gy the cotangents of o and y (gy may be absent):
//   dh  = (go w2) * s            (M, F)
//   dy  = dh w1 + gy             (M, C)
//   dw1 = dh^T y   (F, C)        dw2 = go^T a   (C, F)
//   db1 = column sums of dh      db2 = column sums of go
//   dx, dgamma, dbeta = LayerNorm backward of dy at x     (ln_rows.cuh)
//
// What bounds it: float32 operations, 4*M*C*F of them forward and 8*M*C*F
// backward, against the (M, C) and (M, F) activations plus the weights.  All
// six matrix products are part of the TPU kernels' bodies, so they are
// written here by hand: one shared-memory tiled float32 product (gemm_tiles,
// gemm_tiles.cuh) serves them all, with the bias, the GELU, the product with
// s or the sum with gy in its epilogue.  One forward call is three launches
// on one stream:
//   1. ln_rows (ln_rows.cuh): x -> y;
//   2. gemm_tiles<GELU>: y, w1, b1 -> a (and s);
//   3. gemm_tiles<BIAS>: a, w2, b2 -> o.
// The (M, F) activation a passes through device memory between 2 and 3; the
// TPU kernel keeps it in VMEM, and keeping it in shared memory here is left
// to the tuning of this kernel.  One backward call is, on one stream: the
// two products for dh and dy (dh passes through device memory once, in a
// scratch buffer, never over s), the two weight-gradient products, two
// column sums, and the LayerNorm backward.
//
// gemm_tiles, its epilogues (the bias, the GELU, the product with s, the sum
// with gy) and its launchers are in gemm_tiles.cuh, which also says how the
// weight gradients, sums over all M rows, are split over blockIdx.z and
// added in a fixed order.  db1, db2, dgamma and dbeta are summed the same
// way (reduce.cuh).

#include <cuda_runtime.h>

#include "gemm_tiles.cuh"
#include "ln_rows.cuh"

namespace {

using namespace vitta;

// The backward's scratch, in floats and in this order: dh (m, f), dy (m, c),
// the LayerNorm backward's, the partial weight-gradient products (the larger
// of the two, used one after the other), the partial column sums.
struct BwdScratch {
  long long dh, dy, ln, grad, cols;
  long long total() const { return dh + dy + ln + grad + cols; }
};

BwdScratch bwd_scratch(int m, int c, int f) {
  BwdScratch s;
  s.dh = (long long)m * f;
  s.dy = (long long)m * c;
  // a multiple of 4, so that what follows stays 16-byte aligned
  s.ln = (vitta::ln_bwd_scratch_floats(m, c) + 3) / 4 * 4;
  s.grad = max2(grad_partial_floats(f, c, m), grad_partial_floats(c, f, m));
  s.cols = (long long)vitta::col_chunks(m) * f;
  return s;
}

bool bad_dims(int m, int c, int f) {
  return m <= 0 || c <= 0 || f <= 0 || c % 4 != 0 || f % 4 != 0 ||
         (m + 63) / 64 > 65535;
}

}  // namespace

extern "C" {

// x, y, o: (m, c); w1 (f, c); w2 (c, f); a: (m, f), always written; s: (m, f)
// or null.
int vitta_lnmlp_fwd(const float* x, const float* gamma, const float* beta,
                    const float* w1, const float* b1, const float* w2,
                    const float* b2, float* y, float* a, float* s, float* o,
                    int m, int c, int f, float eps, void* stream) {
  if (bad_dims(m, c, f)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = vitta::launch_ln_rows(x, gamma, beta, y, m, c, eps, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<false, EPI_GELU>(y, w1, b1, nullptr, a, s, m, f, c, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_gemm<false, EPI_BIAS>(a, w2, b2, nullptr, o, nullptr, m,
                                           c, f, st);
}

// Floats of scratch vitta_lnmlp_bwd needs.
long long vitta_lnmlp_bwd_scratch_floats(int m, int c, int f) {
  if (bad_dims(m, c, f)) return -1;
  return bwd_scratch(m, c, f).total();
}

// x, y, go, dx: (m, c); a, s: (m, f); gy: (m, c) or null (no cotangent on
// y); w1, dw1: (f, c); w2, dw2: (c, f); dgb: (2, c) = dgamma then dbeta;
// db1: (f); db2: (c).
int vitta_lnmlp_bwd(const float* x, const float* y, const float* a,
                    const float* s, const float* go, const float* gy,
                    const float* gamma, const float* w1, const float* w2,
                    float* dx, float* dgb, float* dw1, float* db1, float* dw2,
                    float* db2, float* scratch, int m, int c, int f, float eps,
                    void* stream) {
  if (bad_dims(m, c, f) || vitta::col_chunks(m) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const BwdScratch sz = bwd_scratch(m, c, f);
  float* dh = scratch;
  float* dy = dh + sz.dh;
  float* ln = dy + sz.dy;
  float* grad = ln + sz.ln;
  float* cols = grad + sz.grad;
  // dh = (go w2) * s, then dy = dh w1 + gy
  cudaError_t e = launch_gemm<true, EPI_MUL>(go, w2, nullptr, s, dh, nullptr,
                                             m, f, c, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<true, EPI_ADD>(dh, w1, nullptr, gy, dy, nullptr, m, c, f,
                                 st);
  if (e != cudaSuccess) return (int)e;
  // dw1 = dh^T y, dw2 = go^T a, over all m rows
  e = launch_grad_gemm(dh, y, dw1, grad, f, c, m, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_grad_gemm(go, a, dw2, grad, c, f, m, st);
  if (e != cudaSuccess) return (int)e;
  e = vitta::launch_col_sums(dh, cols, db1, m, f, st);
  if (e != cudaSuccess) return (int)e;
  e = vitta::launch_col_sums(go, cols, db2, m, c, st);
  if (e != cudaSuccess) return (int)e;
  return (int)vitta::launch_ln_bwd(x, gamma, dy, dx, dgb, ln, m, c, eps, st);
}

}  // extern "C"
