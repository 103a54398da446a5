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
// too (x and dy read, dx written); the TPU kernel adds dgamma and dbeta into
// one block that its sequential grid revisits, which a CUDA grid cannot:
// here each block keeps its rows' column sums in registers as it makes dx,
// writes one partial, and a second launch adds the partials in block order,
// without atomics (ln_rows.cuh).
//
// At bfloat16 (vitta_tpu runs these kernels at the compute dtype: x, y, dy
// and dx bfloat16; gamma, beta, the statistics, every sum and dgamma and
// dbeta float32, pallas_ln.py:47-73) the same kernels take bfloat16 rows:
// y and dx are rounded once.  The bound halves with the bytes; the forward
// moves 16-byte units of 8 values, the backward units of 4 (8 bytes), so
// that its plan and the columns a lane owns stay those of float32.

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

// The backward's plan, as six numbers: vec, units, batch, wpr, blocks,
// rows_per_block (LnBwdPlan); units 0 where it takes no such shape.
void vitta_ln_bwd_plan(long long rows, int c, int vec, long long* out) {
  const vitta::LnBwdPlan q = vitta::ln_bwd_plan(rows, c, vec != 0);
  const long long v[6] = {q.vec, q.units, q.batch, q.wpr, q.blocks,
                          q.rows_per_block};
  for (int k = 0; k < 6; ++k) out[k] = v[k];
}

// dx (rows, c); dgb (2, c) = dgamma then dbeta.  Two launches.  vec: 16-byte
// units, which the caller takes only where c % 4 == 0 and x, gamma, dy and
// dx are 16-byte aligned; refused otherwise.
int vitta_ln_bwd(const float* x, const float* gamma, const float* dy,
                 float* dx, float* dgb, float* scratch, long long rows, int c,
                 float eps, int vec, void* stream) {
  if (vitta::ln_bwd_plan(rows, c, false).units == 0)
    return (int)cudaErrorInvalidValue;
  if (vec && !vitta::ln_bwd_vec_ok(x, gamma, dy, dx, c))
    return (int)cudaErrorMisalignedAddress;
  return (int)vitta::launch_ln_bwd(x, gamma, dy, dx, dgb, scratch, rows, c,
                                   eps, vec != 0, (cudaStream_t)stream);
}

// The same at bfloat16: x, y, dy, dx bfloat16; gamma, beta, dgb, scratch
// float32.  vec: units of 4 values (8 bytes), refused where x, dy or dx is
// not 8-byte aligned or gamma not 16-byte aligned.
int vitta_ln_fwd_bf16(const void* x, const float* gamma, const float* beta,
                      void* y, long long rows, int c, float eps,
                      void* stream) {
  if (rows < 0 || c <= 0) return (int)cudaErrorInvalidValue;
  return (int)vitta::launch_ln_rows(reinterpret_cast<const vitta::bf16*>(x),
                                    gamma, beta,
                                    reinterpret_cast<vitta::bf16*>(y), rows,
                                    c, eps, (cudaStream_t)stream);
}

int vitta_ln_bwd_bf16(const void* x, const float* gamma, const void* dy,
                      void* dx, float* dgb, float* scratch, long long rows,
                      int c, float eps, int vec, void* stream) {
  const auto* xb = reinterpret_cast<const vitta::bf16*>(x);
  const auto* dyb = reinterpret_cast<const vitta::bf16*>(dy);
  auto* dxb = reinterpret_cast<vitta::bf16*>(dx);
  if (vitta::ln_bwd_plan(rows, c, false).units == 0)
    return (int)cudaErrorInvalidValue;
  if (vec && !vitta::ln_bwd_vec_ok(xb, gamma, dyb, dxb, c))
    return (int)cudaErrorMisalignedAddress;
  return (int)vitta::launch_ln_bwd(xb, gamma, dyb, dxb, dgb, scratch, rows,
                                   c, eps, vec != 0, (cudaStream_t)stream);
}

}  // extern "C"
