// Projection-fused window attention, with and without the LayerNorm
// prologue, forward and backward, for Video Swin, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vitta_tpu/ops/pallas_attention.py:
//   _proj_fwd_kernel (:724), launched by _proj_attn_fwd (:807);
//   _proj_bwd_kernel (:747), launched by _proj_attn_bwd (:850);
//   _proj_ln_fwd_kernel (:945) with _ln_block (:935), launched by
//   _proj_ln_attn_fwd (:1021);
//   _proj_ln_bwd_kernel (:967), launched by _proj_ln_attn_bwd (:1068).
//
// What the forward computes, on windows x (B_, N, C) = (M, C) rows with the
// weights in torch.nn.Linear layout (wqkv (3C, C), wproj (C, C)):
//   y     = LayerNorm(x) * gamma + beta       the LN form only; else y = x
//   qkv   = y wqkv^T + bqkv                   last axis ordered (3, nh, hd)
//   o_att = softmax(scale q k^T + bias[h] + mask[b mod nW]) v   per head
//   out   = o_att wproj^T + bproj
// and returns out and qkv (and y, which the norm1 tap reads); on request it
// keeps o_att and ms, each row's softmax maximum and sum (B_, N, 2nh), for
// the backward.  The bias is dense, (nh, N, N).
//
// What the backward computes, from (x, y, qkv, o_att, ms, g, gy) as the
// forward left them, with g and gy the cotangents of out and y (gy may be
// absent; y is x without the LN):
//   dwproj = g^T o_att  (C, C)      dbproj = column sums of g
//   g_att  = g wproj                (M, C)
//   dqkv, dbias = the packed attention backward of g_att at qkv
//   dwqkv  = dqkv^T y   (3C, C)     dbqkv  = column sums of dqkv
//   dy     = dqkv wqkv + gy         (M, C); this is dx without the LN
//   dx, dgamma, dbeta = LayerNorm backward of dy at x     (ln_rows.cuh)
//
// What bounds it: float32 operations, 8*M*C*C of them in the two forward
// projections and 16*M*C*C in the backward's four products, on top of the
// attention's own.
//
// The TPU kernels handle one window per grid step with wqkv, wproj, the bias
// of every head and the float32 weight-gradient accumulators resident in
// VMEM, and recompute a window's qkv in the backward, where it lived in VMEM
// only.  A Hopper SM has 227 KB of shared memory, where one window's qkv at
// Swin-B's last stage is 4.8 MB and the accumulators are 16.8 MB, so an
// entry point here is a chain of launches on one stream, with g_att, dqkv
// (and dy) in device-memory scratch that the caller allocates, as mlp.cu
// does with its hidden activation.  The forward writes qkv to device memory
// anyway, so it hands it out: the caller keeps it (and y) for the backward,
// which then makes no qkv product and no LayerNorm forward (an eval forward
// keeps nothing).
//   forward:  [ln_rows]  gemm_tiles<BIAS>  packed_attn_fwd  gemm_tiles<BIAS>
//   backward: {g_att, dwproj with dbproj}            launch_rows_and_grad
//             packed attention backward (attn_bwd, [the dk, dv sum],
//             [dbias_reduce])
//             {dx or dy, dwqkv with dbqkv}           launch_rows_and_grad
//             [LayerNorm backward: dx and the blocks' partials]
//             one reduce_sums: dwproj, dbproj, dwqkv, dbqkv [, dgamma, dbeta]
// Each {pair} is one gemm_pair launch where pair_grouped says so (as
// measured: the g_att pair always, the dx pair except where its row product
// alone fills the card with the small tile more than 1.5 times) and two
// launches otherwise.  A bias gradient is the column sums of its weight
// gradient's k-major A, summed from the slices that product stages anyway
// and written as one more row of its k-chunk partials (EPI_PART): no second
// read of g or dqkv.  Every matrix product is gemm_tiles' (gemm_tiles.cuh),
// the attention kernels are those of the packed op (attention_kernels.cuh),
// and every sum over windows or rows goes through per-block partials added
// in a fixed order (reduce.cuh): no float atomics, two runs give the same
// bits.  So 5 or 6 launches without the LN (the attention backward takes 2
// or 3), 6 or 7 with it, where both pairs are one launch, and one more for
// each pair that is not.  A null pointer for dwqkv, dbqkv, dwproj, dbproj
// or dbias leaves that output out (a frozen parameter); a weight-gradient
// product runs where its weight or its bias wants a gradient.
//
// One stream: the scratch is the caller's, allocated per call from a
// stream-ordered allocator, and is read only by launches made here on the
// stream passed in.  A caller that frees it while another stream still runs
// these kernels would have them read freed memory; the port runs everything
// on the current stream.
//
// Limits: those of the attention kernels (N <= 416, hd <= 32) and of
// gemm_tiles (C a multiple of 4).  Float32 only.

#include <cuda_runtime.h>

#include "attention_kernels.cuh"
#include "gemm_tiles.cuh"
#include "ln_rows.cuh"

namespace {

using namespace vitta;

long long round4ll(long long v) { return (v + 3) / 4 * 4; }

bool bad_dims(int b_, int n, int nh, int hd) {
  const long long m = (long long)b_ * n;
  return b_ <= 0 || n <= 0 || nh <= 0 || hd <= 0 || (nh * hd) % 4 != 0 ||
         (m + 63) / 64 > 65535;
}

// The backward's scratch, in floats and in this order; every piece starts
// 16-byte aligned.  gatt holds dy too in the LayerNorm form (g_att is dead
// once the attention backward has read it); ln is used by that form only.
// grad_o and grad_q hold the k-chunk partials of dwproj / dbproj and of
// dwqkv / dbqkv, which the last launch adds up.
struct BwdScratch {
  long long dqkv, gatt, ln, attn, grad_o, grad_q;
  long long total() const { return dqkv + gatt + ln + attn + grad_o + grad_q; }
};

BwdScratch bwd_scratch(int b_, int n, int nh, int hd, bool with_ln) {
  const int c = nh * hd;
  const long long m = (long long)b_ * n;
  BwdScratch s;
  s.dqkv = 3 * m * c;
  s.gatt = m * c;
  s.ln = with_ln ? round4ll(ln_bwd_scratch_floats(m, c)) : 0;
  s.attn = round4ll(attn::bwd_scratch_floats(b_, n, nh, hd));
  s.grad_o = round4ll(grad_sums_floats(c, c, (int)m));
  s.grad_q = round4ll(grad_sums_floats(3 * c, c, (int)m));
  return s;
}

// x -> [y] -> qkv -> o_att -> out.  gamma == null: no LayerNorm, y unused.
cudaError_t forward(const float* x, const float* gamma, const float* beta,
                    const float* wqkv, const float* bqkv, const float* wproj,
                    const float* bproj, const float* bias, const float* mask,
                    float* y, float* qkv, float* o_att, float* ms, float* out,
                    int b_, int n, int nh, int hd, int nw, float eps,
                    float scale, cudaStream_t st) {
  if (bad_dims(b_, n, nh, hd)) return cudaErrorInvalidValue;
  const int c = nh * hd, m = b_ * n;
  cudaError_t e;
  if (gamma != nullptr) {
    e = launch_ln_rows(x, gamma, beta, y, m, c, eps, st);
    if (e != cudaSuccess) return e;
    x = y;
  }
  e = launch_gemm<false, EPI_BIAS>(x, wqkv, bqkv, nullptr, qkv, nullptr, m,
                                   3 * c, c, st);
  if (e != cudaSuccess) return e;
  e = attn::launch_packed_fwd(qkv, bias, mask, o_att, ms, b_, n, nh, hd, nw, 0,
                              0, 0, scale, st);
  if (e != cudaSuccess) return e;
  return launch_gemm<false, EPI_BIAS>(o_att, wproj, bproj, nullptr, out,
                                      nullptr, m, c, c, st);
}

// gamma == null: no LayerNorm; y is x, gy and dgb unused and dx = dqkv wqkv.
cudaError_t backward(const float* x, const float* y, const float* qkv,
                     const float* gamma, const float* wqkv,
                     const float* wproj, const float* bias, const float* mask,
                     const float* o_att, const float* ms, const float* g,
                     const float* gy, float* dx, float* dgb, float* dwqkv,
                     float* dbqkv, float* dwproj, float* dbproj, float* dbias,
                     float* scratch, int b_, int n, int nh, int hd, int nw,
                     float eps, float scale, cudaStream_t st) {
  const bool with_ln = gamma != nullptr;
  const int c = nh * hd, m = b_ * n;
  if (bad_dims(b_, n, nh, hd) || (with_ln && c > kLnBwdMaxC))
    return cudaErrorInvalidValue;
  const BwdScratch sz = bwd_scratch(b_, n, nh, hd, with_ln);
  float* dqkv = scratch;
  float* gatt = dqkv + sz.dqkv;
  float* ln = gatt + sz.gatt;
  float* att = ln + sz.ln;
  float* grad_o = att + sz.attn;
  float* grad_q = grad_o + sz.grad_o;
  const bool want_o = dwproj != nullptr || dbproj != nullptr;
  const bool want_q = dwqkv != nullptr || dbqkv != nullptr;
  // the output projection: g_att = g wproj beside dwproj = g^T o_att and
  // dbproj
  cudaError_t e = launch_rows_and_grad(
      g, wproj, nullptr, gatt, m, c, c, want_o ? g : nullptr, o_att, grad_o,
      c, c, m, pair_grouped(m, c, c), st);
  if (e != cudaSuccess) return e;
  e = attn::launch_packed_bwd(qkv, bias, mask, ms, gatt, dqkv, dbias, att, b_,
                              n, nh, hd, nw, 0, 0, 0, scale, st);
  if (e != cudaSuccess) return e;
  // the qkv projection: dy = dqkv wqkv (+ gy) beside dwqkv = dqkv^T y and
  // dbqkv; dy takes g_att's place
  float* dy = with_ln ? gatt : dx;
  e = launch_rows_and_grad(dqkv, wqkv, with_ln ? gy : nullptr, dy, m, c,
                           3 * c, want_q ? dqkv : nullptr, y, grad_q, 3 * c,
                           c, m, pair_grouped(m, c, 3 * c), st);
  if (e != cudaSuccess) return e;
  PartialSums sums;
  bool fits = true;
  if (with_ln) {
    e = launch_ln_bwd_parts(x, gamma, dy, dx, ln, m, c, eps,
                            ln_bwd_vec_ok(x, gamma, dy, dx, c), st);
    if (e != cudaSuccess) return e;
    fits = sums.add(ln, 2LL * c, dgb, (int)ln_bwd_partial_count(m, c),
                    2LL * c);
  }
  if (want_o)
    fits = fits && add_grad_sums(sums, grad_o, dwproj, dbproj, c, c, m);
  if (want_q)
    fits = fits && add_grad_sums(sums, grad_q, dwqkv, dbqkv, 3 * c, c, m);
  if (!fits) return cudaErrorInvalidValue;
  return launch_reduce_sums(sums, st);
}

}  // namespace

extern "C" {

// x, o_att, out: (b_, n, c) with c = nh*hd; wqkv (3c, c); wproj (c, c);
// bias (nh, n, n); mask (nw, n, n) or null; qkv (b_, n, 3c) and o_att are
// always written, ms (b_, n, 2nh) where it is not null.
int vitta_attn_proj_fwd(const float* x, const float* wqkv, const float* bqkv,
                        const float* wproj, const float* bproj,
                        const float* bias, const float* mask, float* qkv,
                        float* o_att, float* ms, float* out, int b_, int n,
                        int nh, int hd, int nw, float scale, void* stream) {
  return (int)forward(x, nullptr, nullptr, wqkv, bqkv, wproj, bproj, bias,
                      mask, nullptr, qkv, o_att, ms, out, b_, n, nh, hd, nw,
                      0.f, scale, (cudaStream_t)stream);
}

// As vitta_attn_proj_fwd on LayerNorm(x); also writes y (b_, n, c).
int vitta_attn_ln_proj_fwd(const float* x, const float* gamma,
                           const float* beta, const float* wqkv,
                           const float* bqkv, const float* wproj,
                           const float* bproj, const float* bias,
                           const float* mask, float* y, float* qkv,
                           float* o_att, float* ms, float* out, int b_, int n,
                           int nh, int hd, int nw, float eps, float scale,
                           void* stream) {
  if (gamma == nullptr || beta == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)forward(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask, y,
                      qkv, o_att, ms, out, b_, n, nh, hd, nw, eps, scale,
                      (cudaStream_t)stream);
}

// Floats of scratch the backward needs, with or without the LayerNorm.
long long vitta_attn_proj_bwd_scratch_floats(int b_, int n, int nh, int hd,
                                             int with_ln) {
  if (bad_dims(b_, n, nh, hd)) return -1;
  return bwd_scratch(b_, n, nh, hd, with_ln != 0).total();
}

// x, qkv, o_att, ms as the forward left them; g, dx: (b_, n, c); dwqkv
// (3c, c); dbqkv (3c); dwproj (c, c); dbproj (c); dbias (nh, n, n); each of
// the last five may be null, and is then not computed.
int vitta_attn_proj_bwd(const float* x, const float* qkv, const float* wqkv,
                        const float* wproj, const float* bias,
                        const float* mask, const float* o_att,
                        const float* ms, const float* g, float* dx,
                        float* dwqkv, float* dbqkv, float* dwproj,
                        float* dbproj, float* dbias, float* scratch, int b_,
                        int n, int nh, int hd, int nw, float scale,
                        void* stream) {
  return (int)backward(x, x, qkv, nullptr, wqkv, wproj, bias, mask, o_att, ms,
                       g, nullptr, dx, nullptr, dwqkv, dbqkv, dwproj, dbproj,
                       dbias, scratch, b_, n, nh, hd, nw, 0.f, scale,
                       (cudaStream_t)stream);
}

// As vitta_attn_proj_bwd, through the LayerNorm: y as the forward wrote it;
// gy (b_, n, c) is the cotangent of y or null; dgb (2, c) = dgamma then
// dbeta.
int vitta_attn_ln_proj_bwd(const float* x, const float* y, const float* qkv,
                           const float* gamma, const float* wqkv,
                           const float* wproj, const float* bias,
                           const float* mask, const float* o_att,
                           const float* ms, const float* g, const float* gy,
                           float* dx, float* dgb, float* dwqkv, float* dbqkv,
                           float* dwproj, float* dbproj, float* dbias,
                           float* scratch, int b_, int n, int nh, int hd,
                           int nw, float eps, float scale, void* stream) {
  if (gamma == nullptr || y == nullptr || dgb == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)backward(x, y, qkv, gamma, wqkv, wproj, bias, mask, o_att, ms,
                       g, gy, dx, dgb, dwqkv, dbqkv, dwproj, dbproj, dbias,
                       scratch, b_, n, nh, hd, nw, eps, scale,
                       (cudaStream_t)stream);
}

}  // extern "C"
