// Row LayerNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vitta_tpu/ops/pallas_ln.py:
//   _fwd_kernel (:47, launched by _ln_fwd :81) and
//   _bwd_kernel (:55, launched by _ln_bwd :96).
//
// What it computes, per row of an (R, C) float32 matrix:
//   y = (x - mu) * rsqrt(E[x^2] - mu^2 + eps) * gamma + beta
// with the one-pass float32 statistics of the TPU kernel, and from
// (x, gamma, dy), with the statistics recomputed as the TPU kernel does:
//   dx, dgamma (C), dbeta (C)          (formulas in ln_rows.cuh)
//
// What bounds it: bytes.  A handful of operations per element against one
// read and one write of the activation, so the design (ln_rows.cuh) keeps a
// row in one warp's registers between the read and the write: 16-byte loads
// and stores, neighbouring lanes on neighbouring addresses, two shuffle
// reductions, no shared memory and no second pass over device memory.  The
// TPU kernel's row blocks (a power-of-two divisor of R) have no counterpart:
// any R is taken, eight rows to a block.  The backward is bound by bytes
// too; the TPU kernel adds dgamma and dbeta into one block that its
// sequential grid revisits, which a CUDA grid cannot: ln_rows.cuh sums them
// by chunks of rows and adds the chunks in a fixed order, without atomics.

#include "ln_rows.cuh"

extern "C" {

int vitta_ln_fwd(const float* x, const float* gamma, const float* beta,
                 float* y, long long rows, int c, float eps, void* stream) {
  if (rows < 0 || c <= 0) return (int)cudaErrorInvalidValue;
  return (int)vitta::launch_ln_rows(x, gamma, beta, y, rows, c, eps,
                                    (cudaStream_t)stream);
}

// Floats of scratch vitta_ln_bwd needs.
long long vitta_ln_bwd_scratch_floats(long long rows, int c) {
  return vitta::ln_bwd_scratch_floats(rows, c);
}

// dx (rows, c); dgb (2, c) = dgamma then dbeta.
int vitta_ln_bwd(const float* x, const float* gamma, const float* dy,
                 float* dx, float* dgb, float* scratch, long long rows, int c,
                 float eps, void* stream) {
  if (rows <= 0 || c <= 0 || vitta::col_chunks(rows) > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)vitta::launch_ln_bwd(x, gamma, dy, dx, dgb, scratch, rows, c,
                                   eps, (cudaStream_t)stream);
}

}  // extern "C"
