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
// and returns out (and y, which the norm1 tap reads); on request it keeps
// o_att and ms, each row's softmax maximum and sum (B_, N, 2nh), for the
// backward.  The bias is dense, (nh, N, N).
//
// What the backward computes, from (x, o_att, ms, g, gy) with g and gy the
// cotangents of out and y (gy may be absent), qkv (and y) recomputed from x:
//   dwproj = g^T o_att  (C, C)      dbproj = column sums of g
//   g_att  = g wproj                (M, C)
//   dqkv, dbias = the packed attention backward of g_att at qkv
//   dwqkv  = dqkv^T y   (3C, C)     dbqkv  = column sums of dqkv
//   dy     = dqkv wqkv + gy         (M, C); this is dx without the LN
//   dx, dgamma, dbeta = LayerNorm backward of dy at x     (ln_rows.cuh)
//
// What bounds it: float32 operations, 8*M*C*C of them in the two forward
// projections and 16*M*C*C in the backward's four products (and 6*M*C*C more
// for the recomputed qkv), on top of the attention's own.
//
// The TPU kernels handle one window per grid step with wqkv, wproj, the bias
// of every head and the float32 weight-gradient accumulators resident in
// VMEM.  A Hopper SM has 227 KB of shared memory, where one window's qkv at
// Swin-B's last stage is 4.8 MB and the accumulators are 16.8 MB, so an
// entry point here is a chain of launches on one stream, with qkv, g_att,
// dqkv (and y, dy) in device-memory scratch that the caller allocates, as
// mlp.cu does with its hidden activation:
//   forward:  [ln_rows]  gemm_tiles<BIAS>  packed_attn_fwd  gemm_tiles<BIAS>
//   backward: [ln_rows]  grad product + column sums (dwproj, dbproj)
//             gemm_tiles (g_att)   gemm_tiles<BIAS> (qkv again)
//             packed attention backward (attn_bwd, [the dk, dv sum],
//             [dbias_reduce])
//             gemm_tiles<ADD> (dx or dy)   grad product + column sums
//             (dwqkv, dbqkv)   [LayerNorm backward]
// Every matrix product is gemm_tiles (gemm_tiles.cuh), the attention kernels
// are those of the packed op (attention_kernels.cuh), and every sum over
// windows or rows goes through per-block partials added in a fixed order
// (reduce.cuh): no float atomics, two runs give the same bits.  A null
// pointer for dwqkv, dbqkv, dwproj, dbproj or dbias skips that output's
// launches (a frozen parameter).
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
         (m + 63) / 64 > 65535 || col_chunks(m) > 65535;
}

// The backward's scratch, in floats and in this order; every piece starts
// 16-byte aligned.  y, dy and ln are used by the LayerNorm form only.
struct BwdScratch {
  long long qkv, dqkv, gatt, y, dy, ln, attn, grad, cols;
  long long total() const {
    return qkv + dqkv + gatt + y + dy + ln + attn + grad + cols;
  }
};

BwdScratch bwd_scratch(int b_, int n, int nh, int hd, bool with_ln) {
  const int c = nh * hd;
  const long long m = (long long)b_ * n;
  BwdScratch s;
  s.qkv = s.dqkv = 3 * m * c;
  s.gatt = m * c;
  s.y = s.dy = with_ln ? m * c : 0;
  s.ln = with_ln ? round4ll(ln_bwd_scratch_floats(m, c)) : 0;
  s.attn = round4ll(attn::bwd_scratch_floats(b_, n, nh, hd));
  s.grad = max2(grad_partial_floats(3 * c, c, (int)m),
                grad_partial_floats(c, c, (int)m));
  s.cols = (long long)col_chunks(m) * 3 * c;
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

// gamma == null: no LayerNorm; gy, dgb unused and dx = dqkv wqkv.
cudaError_t backward(const float* x, const float* gamma, const float* beta,
                     const float* wqkv, const float* bqkv, const float* wproj,
                     const float* bias, const float* mask, const float* o_att,
                     const float* ms, const float* g, const float* gy,
                     float* dx, float* dgb, float* dwqkv, float* dbqkv,
                     float* dwproj, float* dbproj, float* dbias,
                     float* scratch, int b_, int n, int nh, int hd, int nw,
                     float eps, float scale, cudaStream_t st) {
  if (bad_dims(b_, n, nh, hd)) return cudaErrorInvalidValue;
  const bool with_ln = gamma != nullptr;
  const int c = nh * hd, m = b_ * n;
  const BwdScratch sz = bwd_scratch(b_, n, nh, hd, with_ln);
  float* qkv = scratch;
  float* dqkv = qkv + sz.qkv;
  float* gatt = dqkv + sz.dqkv;
  float* y = gatt + sz.gatt;
  float* dy = y + sz.y;
  float* ln = dy + sz.dy;
  float* att = ln + sz.ln;
  float* grad = att + sz.attn;
  float* cols = grad + sz.grad;
  cudaError_t e;
  // the input of the qkv projection: y, recomputed, or x itself
  const float* yin = x;
  if (with_ln) {
    e = launch_ln_rows(x, gamma, beta, y, m, c, eps, st);
    if (e != cudaSuccess) return e;
    yin = y;
  }
  // the output projection: dwproj = g^T o_att, dbproj, g_att = g wproj
  if (dwproj != nullptr) {
    e = launch_grad_gemm(g, o_att, dwproj, grad, c, c, m, st);
    if (e != cudaSuccess) return e;
  }
  if (dbproj != nullptr) {
    e = launch_col_sums(g, cols, dbproj, m, c, st);
    if (e != cudaSuccess) return e;
  }
  e = launch_gemm<true, EPI_ADD>(g, wproj, nullptr, nullptr, gatt, nullptr, m,
                                 c, c, st);
  if (e != cudaSuccess) return e;
  // qkv again, then the attention backward
  e = launch_gemm<false, EPI_BIAS>(yin, wqkv, bqkv, nullptr, qkv, nullptr, m,
                                   3 * c, c, st);
  if (e != cudaSuccess) return e;
  e = attn::launch_packed_bwd(qkv, bias, mask, ms, gatt, dqkv, dbias, att, b_,
                              n, nh, hd, nw, 0, 0, 0, scale, st);
  if (e != cudaSuccess) return e;
  // the qkv projection: dy = dqkv wqkv (+ gy), dwqkv = dqkv^T y, dbqkv
  e = launch_gemm<true, EPI_ADD>(dqkv, wqkv, nullptr, with_ln ? gy : nullptr,
                                 with_ln ? dy : dx, nullptr, m, c, 3 * c, st);
  if (e != cudaSuccess) return e;
  if (dwqkv != nullptr) {
    e = launch_grad_gemm(dqkv, yin, dwqkv, grad, 3 * c, c, m, st);
    if (e != cudaSuccess) return e;
  }
  if (dbqkv != nullptr) {
    e = launch_col_sums(dqkv, cols, dbqkv, m, 3 * c, st);
    if (e != cudaSuccess) return e;
  }
  if (!with_ln) return cudaSuccess;
  return launch_ln_bwd(x, gamma, dy, dx, dgb, ln, m, c, eps, st);
}

}  // namespace

extern "C" {

// Floats of scratch the forward needs: qkv (b_, n, 3c).
long long vitta_attn_proj_fwd_scratch_floats(int b_, int n, int nh, int hd) {
  if (bad_dims(b_, n, nh, hd)) return -1;
  return 3LL * b_ * n * nh * hd;
}

// Floats of scratch the backward needs, with or without the LayerNorm.
long long vitta_attn_proj_bwd_scratch_floats(int b_, int n, int nh, int hd,
                                             int with_ln) {
  if (bad_dims(b_, n, nh, hd)) return -1;
  return bwd_scratch(b_, n, nh, hd, with_ln != 0).total();
}

// x, o_att, out: (b_, n, c) with c = nh*hd; wqkv (3c, c); wproj (c, c);
// bias (nh, n, n); mask (nw, n, n) or null; ms (b_, n, 2nh) or null; o_att
// is always written; scratch as vitta_attn_proj_fwd_scratch_floats says.
int vitta_attn_proj_fwd(const float* x, const float* wqkv, const float* bqkv,
                        const float* wproj, const float* bproj,
                        const float* bias, const float* mask, float* o_att,
                        float* ms, float* out, float* scratch, int b_, int n,
                        int nh, int hd, int nw, float scale, void* stream) {
  return (int)forward(x, nullptr, nullptr, wqkv, bqkv, wproj, bproj, bias,
                      mask, nullptr, scratch, o_att, ms, out, b_, n, nh, hd,
                      nw, 0.f, scale, (cudaStream_t)stream);
}

// As vitta_attn_proj_fwd on LayerNorm(x); also writes y (b_, n, c).
int vitta_attn_ln_proj_fwd(const float* x, const float* gamma,
                           const float* beta, const float* wqkv,
                           const float* bqkv, const float* wproj,
                           const float* bproj, const float* bias,
                           const float* mask, float* y, float* o_att,
                           float* ms, float* out, float* scratch, int b_,
                           int n, int nh, int hd, int nw, float eps,
                           float scale, void* stream) {
  if (gamma == nullptr || beta == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)forward(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask, y,
                      scratch, o_att, ms, out, b_, n, nh, hd, nw, eps, scale,
                      (cudaStream_t)stream);
}

// g, dx: (b_, n, c); dwqkv (3c, c); dbqkv (3c); dwproj (c, c); dbproj (c);
// dbias (nh, n, n); each of the last five may be null, and is then not
// computed.
int vitta_attn_proj_bwd(const float* x, const float* wqkv, const float* bqkv,
                        const float* wproj, const float* bias,
                        const float* mask, const float* o_att,
                        const float* ms, const float* g, float* dx,
                        float* dwqkv, float* dbqkv, float* dwproj,
                        float* dbproj, float* dbias, float* scratch, int b_,
                        int n, int nh, int hd, int nw, float scale,
                        void* stream) {
  return (int)backward(x, nullptr, nullptr, wqkv, bqkv, wproj, bias, mask,
                       o_att, ms, g, nullptr, dx, nullptr, dwqkv, dbqkv,
                       dwproj, dbproj, dbias, scratch, b_, n, nh, hd, nw, 0.f,
                       scale, (cudaStream_t)stream);
}

// As vitta_attn_proj_bwd, through the LayerNorm: gy (b_, n, c) is the
// cotangent of y or null; dgb (2, c) = dgamma then dbeta.
int vitta_attn_ln_proj_bwd(const float* x, const float* gamma,
                           const float* beta, const float* wqkv,
                           const float* bqkv, const float* wproj,
                           const float* bias, const float* mask,
                           const float* o_att, const float* ms, const float* g,
                           const float* gy, float* dx, float* dgb,
                           float* dwqkv, float* dbqkv, float* dwproj,
                           float* dbproj, float* dbias, float* scratch, int b_,
                           int n, int nh, int hd, int nw, float eps,
                           float scale, void* stream) {
  if (gamma == nullptr || beta == nullptr || dgb == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)backward(x, gamma, beta, wqkv, bqkv, wproj, bias, mask, o_att,
                       ms, g, gy, dx, dgb, dwqkv, dbqkv, dwproj, dbproj, dbias,
                       scratch, b_, n, nh, hd, nw, eps, scale,
                       (cudaStream_t)stream);
}

}  // extern "C"
