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
// gemm_tiles (C a multiple of 4).
//
// At bfloat16 (vitta_attn_{proj,ln_proj}_{fwd,bwd}_bf16: the same Pallas
// kernels at the compute dtype, which vitta_tpu runs under
// VITTA_ATTN_PROJ_FUSED / VITTA_ATTN_LN with dtype=bfloat16; x, y, qkv,
// o_att, out, the weights, their biases, g, gy, dx and the weight and bias
// gradients bfloat16; gamma, beta, the dense bias, the mask, ms, dbias,
// dgamma, dbeta and the scratch float32) the chains are the same, on the
// bfloat16 parts of the port:
//   forward:  [ln_rows bf16]  gemm_wgmma_bf16<DENSE>  attn_fwd_dense_bf16
//             gemm_wgmma_bf16<DENSE>
//   backward: g_att = bfloat16(g wproj)                  gemm_wgmma_bf16
//             dqkv, dbias: the bfloat16 attention backward (the kernel,
//             [the dk, dv sum], dbias_reduce_x4: dl over the windows in
//             their order)
//             dx = bfloat16(dqkv wqkv), or under the LayerNorm
//             dy = dqkv wqkv + gy, float32, never rounded  gemm_wgmma_bf16
//             dwqkv = dqkv^T y and dwproj = g^T o_att     one launch
//             the column partials of g and of dqkv        one launch
//             [LayerNorm backward on the bfloat16 x and the float32 dy]
//             one reduce_sums: [dwqkv, dwproj where their K is cut],
//             dbproj, dbqkv [, dgamma, dbeta]
// 3 launches forward (4 with the LayerNorm); backward 7 or 8 (8 or 9).
// They round where the TPU kernels round: qkv and out as flax's Dense at
// the compute dtype, the product rounded before the bfloat16 bias is added
// and the sum rounded again (EPI_DENSE, pallas_attention.py:732, :737,
// :955, :960); g_att once (:768-770); dx once (:777-779), where the
// LayerNorm form keeps dy float32 (:1003-1005) for the LayerNorm backward;
// dwqkv, dwproj, dbqkv and dbproj are float32 sums over every row, each
// rounded once (the VJP's .astype(w.dtype), :914-916, :1140-1143).  The
// attention is the packed bfloat16 pair's (attention_kernels.cuh) on the
// dense bias, which vitta_tpu hands these kernels.  Every bfloat16 pointer
// must be 16-byte aligned and hd a multiple of 8 (so C too): TMA's rules
// and the attention kernels' 16-byte rows.

#include <cuda_runtime.h>

#include "attention_kernels.cuh"
#include "gemm_tiles.cuh"
#include "gemm_wgmma_bf16.cuh"
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

// ------------------------------------------------------------- bfloat16

bool bad_dims_bf16(int b_, int n, int nh, int hd) {
  return bad_dims(b_, n, nh, hd) || hd % 8 != 0 || hd > attn::kMaxHeadDim ||
         n > attn::kMaxTokens;
}

// The six bfloat16 products, each C (M, N) over K from m rows of width c:
// qkv = y wqkv^T, out = o_att wproj^T, g_att = g wproj, dx (or dy) = dqkv
// wqkv, dwqkv = dqkv^T y, dwproj = g^T o_att.
constexpr int kQkv = 0, kOut = 1, kGatt = 2, kDx = 3, kDwqkv = 4,
              kDwproj = 5;
constexpr int kProducts = 6;

struct PDims {
  int M, N, K;
};

PDims product_dims(int which, int m, int c) {
  switch (which) {
    case kQkv:   return PDims{m, 3 * c, c};
    case kOut:   return PDims{m, c, c};
    case kGatt:  return PDims{m, c, c};
    case kDx:    return PDims{m, c, 3 * c};
    case kDwqkv: return PDims{3 * c, c, m};
    default:     return PDims{c, c, m};
  }
}

// A product's plan, as mlp.cu's bf16_plan cuts the MLP's: the two weight
// gradients share one launch, their chunks of K cut for the tiles of both.
WgPlan bf16_plan(int which, int m, int c) {
  const PDims d = product_dims(which, m, c);
  const int sms = sm_count();
  if (which < kDwqkv) return wg_row_plan(d.M, d.N, d.K, sms);
  const long long tiles = wg_grad_tiles(3 * c, c) + wg_grad_tiles(c, c);
  WgPlan p = wg_grad_plan(d.M, d.N, d.K, tiles, sms);
  const int work = wg_grad_plan(3 * c, c, m, tiles, sms).work +
                   wg_grad_plan(c, c, m, tiles, sms).work;
  const int slots = (p.bm == 64 ? 2 : 1) * sms;
  p.grid = work < slots ? work : slots;
  return p;
}

// Floats of a weight gradient's chunk partials (none where K is one chunk).
long long grad_partial_floats_bf16(int which, int m, int c) {
  const PDims d = product_dims(which, m, c);
  const WgPlan p = bf16_plan(which, m, c);
  return p.splits > 1 ? (long long)p.splits * d.M * d.N : 0;
}

// The bfloat16 backward's scratch, in floats and in this order, every piece
// 16-byte aligned: g_att (m, c) bfloat16, dqkv (m, 3c) bfloat16, dy (m, c)
// float32 and the LayerNorm backward's partials (the LayerNorm form only),
// the attention backward's (dl (b_, nh, n, n) first), the weight
// gradients' chunk partials (dwqkv's, then dwproj's), the column partials
// (dbproj's, col_chunks(m) rows of c, then dbqkv's, of 3c).
struct Bf16BwdScratch {
  long long gatt, dqkv, dy, ln, attn, grad, cols;
  long long total() const { return gatt + dqkv + dy + ln + attn + grad + cols; }
};

Bf16BwdScratch bf16_bwd_scratch(int b_, int n, int nh, int hd, bool with_ln) {
  const int c = nh * hd;
  const long long m = (long long)b_ * n;
  Bf16BwdScratch s;
  s.gatt = round4ll(m * c / 2);
  s.dqkv = round4ll(3 * m * c / 2);
  s.dy = with_ln ? m * c : 0;
  s.ln = with_ln ? round4ll(ln_bwd_scratch_floats(m, c)) : 0;
  s.attn = round4ll(attn::bwd_bf16_scratch_floats(b_, n, nh, hd, 0, 0, 0, 0));
  s.grad = grad_partial_floats_bf16(kDwqkv, (int)m, c) +
           grad_partial_floats_bf16(kDwproj, (int)m, c);
  s.cols = (long long)col_chunks(m) * 4 * c;
  return s;
}

const bf16* as_bf16(const void* p) { return reinterpret_cast<const bf16*>(p); }
bf16* as_bf16(void* p) { return reinterpret_cast<bf16*>(p); }

// A row product by its plan, rounded in its epilogue; a plan that cuts K
// (the variants' VITTA_WG_ROW_SPLIT) is refused: no partials here.
template <bool B_MN, int EPI>
cudaError_t row_product(const CUtensorMap& ta, const CUtensorMap& tb,
                        const bf16* bias, const bf16* aux, const Bf16Out& out,
                        int which, int m, int c, cudaStream_t st) {
  const PDims d = product_dims(which, m, c);
  const WgPlan p = bf16_plan(which, m, c);
  if (p.splits > 1) return cudaErrorNotSupported;
  return wgmma_product<false, B_MN, EPI>(ta, tb, bias, aux, out, nullptr,
                                         d.M, d.N, d.K, p, st);
}

// x -> [y] -> qkv -> o_att -> out at bfloat16.  gamma == null: no
// LayerNorm, y unused.
cudaError_t forward_bf16(const bf16* x, const float* gamma, const float* beta,
                         const bf16* wqkv, const bf16* bqkv,
                         const bf16* wproj, const bf16* bproj,
                         const float* bias, const float* mask, bf16* y,
                         bf16* qkv, bf16* o_att, float* ms, bf16* out,
                         bf16* e_tap, int b_, int n, int nh, int hd, int nw,
                         float eps, float scale, cudaStream_t st) {
  if (bad_dims_bf16(b_, n, nh, hd) || bias == nullptr || qkv == nullptr ||
      o_att == nullptr || out == nullptr)
    return cudaErrorInvalidValue;
  if (!all_aligned16({x, gamma, beta, wqkv, bqkv, wproj, bproj, y, qkv,
                      o_att, out, e_tap}))
    return cudaErrorMisalignedAddress;
  const int c = nh * hd, m = b_ * n;
  cudaError_t e;
  if (gamma != nullptr) {
    e = launch_ln_rows(x, gamma, beta, y, m, c, eps, st);
    if (e != cudaSuccess) return e;
    x = y;
  }
  CUtensorMap mx, mw, mo, mp;
  if (!make_map(&mx, x, m, c) || !make_map(&mw, wqkv, 3LL * c, c) ||
      !make_map(&mo, o_att, m, c) || !make_map(&mp, wproj, c, c))
    return cudaErrorInvalidValue;
  e = row_product<false, EPI_DENSE>(mx, mw, bqkv, nullptr,
                                    Bf16Out{nullptr, qkv, nullptr}, kQkv, m,
                                    c, st);
  if (e != cudaSuccess) return e;
  e = attn::launch_packed_fwd_bf16(qkv, bias, mask, o_att, ms, e_tap, b_, n,
                                   nh, hd, nw, 0, 0, 0, scale, st);
  if (e != cudaSuccess) return e;
  return row_product<false, EPI_DENSE>(mo, mp, bproj, nullptr,
                                       Bf16Out{nullptr, out, nullptr}, kOut,
                                       m, c, st);
}

// gamma == null: no LayerNorm; y is x, gy and dgb unused and dx =
// bfloat16(dqkv wqkv).  dbias is always written (the bfloat16 attention
// backward's dl is summed into it); each of dwqkv, dbqkv, dwproj, dbproj
// may be null.
cudaError_t backward_bf16(const bf16* x, const bf16* y, const bf16* qkv,
                          const float* gamma, const bf16* wqkv,
                          const bf16* wproj, const float* bias,
                          const float* mask, const bf16* o_att,
                          const float* ms, const bf16* g, const bf16* gy,
                          bf16* dx, float* dgb, bf16* dwqkv, bf16* dbqkv,
                          bf16* dwproj, bf16* dbproj, float* dbias,
                          float* scratch, bf16* e_tap, int b_, int n, int nh,
                          int hd, int nw, float eps, float scale,
                          cudaStream_t st) {
  const bool with_ln = gamma != nullptr;
  const int c = nh * hd, m = b_ * n;
  if (bad_dims_bf16(b_, n, nh, hd) || (with_ln && c > kLnBwdMaxC) ||
      col_chunks(m) > 65535 || dbias == nullptr || ms == nullptr ||
      scratch == nullptr || dx == nullptr)
    return cudaErrorInvalidValue;
  if (!all_aligned16({x, y, qkv, gamma, wqkv, wproj, o_att, g, gy, dx, dgb,
                      dwqkv, dbqkv, dwproj, dbproj, scratch, e_tap}))
    return cudaErrorMisalignedAddress;
  const Bf16BwdScratch sz = bf16_bwd_scratch(b_, n, nh, hd, with_ln);
  bf16* gatt = as_bf16(static_cast<void*>(scratch));
  bf16* dqkv = as_bf16(static_cast<void*>(scratch + sz.gatt));
  float* dy = scratch + sz.gatt + sz.dqkv;
  float* ln = dy + sz.dy;
  float* att = ln + sz.ln;
  float* grad_q = att + sz.attn;
  float* grad_o = grad_q + grad_partial_floats_bf16(kDwqkv, m, c);
  float* cols_o = grad_q + sz.grad;
  float* cols_q = cols_o + (long long)col_chunks(m) * c;
  CUtensorMap mg, mwp, mdq, mwq, my, mo;
  if (!make_map(&mg, g, m, c) || !make_map(&mwp, wproj, c, c) ||
      !make_map(&mdq, dqkv, m, 3LL * c) || !make_map(&mwq, wqkv, 3LL * c, c) ||
      !make_map(&my, y, m, c) || !make_map(&mo, o_att, m, c))
    return cudaErrorInvalidValue;
  // g_att = bfloat16(g wproj)
  cudaError_t e = row_product<true, EPI_ADD>(
      mg, mwp, nullptr, nullptr, Bf16Out{nullptr, gatt, nullptr}, kGatt, m,
      c, st);
  if (e != cudaSuccess) return e;
  e = attn::launch_packed_bwd_bf16(qkv, bias, mask, ms, gatt, dqkv, dbias,
                                   att, e_tap, b_, n, nh, hd, nw, 0, 0, 0,
                                   scale, st);
  if (e != cudaSuccess) return e;
  // dx = bfloat16(dqkv wqkv), or float32 dy = dqkv wqkv + gy
  e = row_product<true, EPI_ADD>(
      mdq, mwq, nullptr, with_ln ? gy : nullptr,
      with_ln ? Bf16Out{dy, nullptr, nullptr} : Bf16Out{nullptr, dx, nullptr},
      kDx, m, c, st);
  if (e != cudaSuccess) return e;
  // dwqkv = dqkv^T y and dwproj = g^T o_att in one launch, each rounded in
  // its epilogue or, where its plan cuts K, in the reduce below
  const WgGrad gq{&mdq, &my, 3 * c, c, m, bf16_plan(kDwqkv, m, c), dwqkv,
                  grad_q};
  const WgGrad go{&mg, &mo, c, c, m, bf16_plan(kDwproj, m, c), dwproj,
                  grad_o};
  if (dwqkv != nullptr || dwproj != nullptr) {
    e = dwqkv == nullptr   ? wgmma_grads(go, nullptr, st)
        : dwproj == nullptr ? wgmma_grads(gq, nullptr, st)
                            : wgmma_grads(gq, &go, st);
    if (e != cudaSuccess) return e;
  }
  // the bias gradients' column partials, g's and dqkv's
  if (dbproj != nullptr || dbqkv != nullptr) {
    e = dbproj == nullptr
            ? launch_col_partials2<bf16>(dqkv, cols_q, 3 * c, nullptr,
                                         nullptr, 0, m, st)
            : launch_col_partials2<bf16>(g, cols_o, c,
                                         dbqkv != nullptr ? dqkv : nullptr,
                                         cols_q, 3 * c, m, st);
    if (e != cudaSuccess) return e;
  }
  PartialSums sums;
  bool fits = true;
  if (with_ln) {
    e = launch_ln_bwd_parts(x, gamma, static_cast<const float*>(dy), dx, ln,
                            m, c, eps,
                            ln_bwd_vec_ok(x, gamma,
                                          static_cast<const float*>(dy), dx,
                                          c),
                            st);
    if (e != cudaSuccess) return e;
    fits = sums.add(ln, 2LL * c, dgb, (int)ln_bwd_partial_count(m, c),
                    2LL * c);
  }
  if (dwqkv != nullptr && gq.plan.splits > 1)
    fits = fits && sums.add(grad_q, 3LL * c * c, dwqkv, gq.plan.splits,
                            3LL * c * c);
  if (dwproj != nullptr && go.plan.splits > 1)
    fits = fits && sums.add(grad_o, (long long)c * c, dwproj, go.plan.splits,
                            (long long)c * c);
  fits = fits && sums.add(cols_o, (long long)c, dbproj, col_chunks(m),
                          (long long)c);
  fits = fits && sums.add(cols_q, 3LL * c, dbqkv, col_chunks(m), 3LL * c);
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

// ------------------------------------------------------------- bfloat16
// The four entries at bfloat16, with the float32 entries' arguments (the
// types as the header says) and e_tap before the stream: nullptr on the
// model's path; a check passes (b_, nh, n, n) bfloat16 for the attention
// kernel's rounded e (its kTap instances).  cudaErrorMisalignedAddress
// where a bfloat16 tensor or the scratch is not 16-byte aligned,
// InvalidValue for a shape the kernels do not take.

int vitta_attn_proj_fwd_bf16(const void* x, const void* wqkv,
                             const void* bqkv, const void* wproj,
                             const void* bproj, const float* bias,
                             const float* mask, void* qkv, void* o_att,
                             float* ms, void* out, int b_, int n, int nh,
                             int hd, int nw, float scale, void* e_tap,
                             void* stream) {
  return (int)forward_bf16(as_bf16(x), nullptr, nullptr, as_bf16(wqkv),
                           as_bf16(bqkv), as_bf16(wproj), as_bf16(bproj),
                           bias, mask, nullptr, as_bf16(qkv), as_bf16(o_att),
                           ms, as_bf16(out), as_bf16(e_tap), b_, n, nh, hd,
                           nw, 0.f, scale, (cudaStream_t)stream);
}

int vitta_attn_ln_proj_fwd_bf16(const void* x, const float* gamma,
                                const float* beta, const void* wqkv,
                                const void* bqkv, const void* wproj,
                                const void* bproj, const float* bias,
                                const float* mask, void* y, void* qkv,
                                void* o_att, float* ms, void* out, int b_,
                                int n, int nh, int hd, int nw, float eps,
                                float scale, void* e_tap, void* stream) {
  if (gamma == nullptr || beta == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)forward_bf16(as_bf16(x), gamma, beta, as_bf16(wqkv),
                           as_bf16(bqkv), as_bf16(wproj), as_bf16(bproj),
                           bias, mask, as_bf16(y), as_bf16(qkv),
                           as_bf16(o_att), ms, as_bf16(out), as_bf16(e_tap),
                           b_, n, nh, hd, nw, eps, scale,
                           (cudaStream_t)stream);
}

// Floats of scratch the bfloat16 backward needs, with or without the
// LayerNorm; -1 for a shape it refuses.
long long vitta_attn_proj_bwd_bf16_scratch_floats(int b_, int n, int nh,
                                                  int hd, int with_ln) {
  if (bad_dims_bf16(b_, n, nh, hd)) return -1;
  return bf16_bwd_scratch(b_, n, nh, hd, with_ln != 0).total();
}

// Where the bfloat16 backward leaves its intermediates in its scratch, in
// floats from its start: offsets[0] g_att (b_, n, c) bfloat16, [1] dqkv
// (b_, n, 3c) bfloat16, [2] dy (b_, n, c) float32 (-1 without the
// LayerNorm), [3] the attention backward's dl (b_, nh, n, n) float32; all
// -1 for a shape it refuses.
void vitta_attn_proj_bwd_bf16_plan(int b_, int n, int nh, int hd,
                                   int with_ln, long long* offsets) {
  if (bad_dims_bf16(b_, n, nh, hd)) {
    offsets[0] = offsets[1] = offsets[2] = offsets[3] = -1;
    return;
  }
  const Bf16BwdScratch sz = bf16_bwd_scratch(b_, n, nh, hd, with_ln != 0);
  offsets[0] = 0;
  offsets[1] = sz.gatt;
  offsets[2] = with_ln ? sz.gatt + sz.dqkv : -1;
  offsets[3] = sz.gatt + sz.dqkv + sz.dy + sz.ln;
}

// How the six products are cut on this card for m rows of width c, in the
// order qkv, out, g_att, dx, dwqkv, dwproj: six ints each (out: 36), the
// tile's rows and columns, the chunks of K, their length, the persistent
// grid and the block's dynamic shared memory in bytes, as
// vitta_lnmlp_bf16_plan gives the MLP's; all -1 where c is no multiple of 8.
void vitta_attn_proj_bf16_plan(int m, int c, int* out) {
  for (int which = 0; which < kProducts; ++which) {
    int* q = out + 6 * which;
    if (m <= 0 || c <= 0 || c % 8 != 0) {
      q[0] = q[1] = q[2] = q[3] = q[4] = q[5] = -1;
      continue;
    }
    const WgPlan p = bf16_plan(which, m, c);
    q[0] = p.bm, q[1] = p.bn, q[2] = p.splits, q[3] = p.kchunk, q[4] = p.grid;
    q[5] = p.bm == 64    ? WgShape<64, 128, kStages64>::smem
           : p.bn == 256 ? WgShape<128, 256, 3>::smem
                         : WgShape<128, 128, kStages128>::smem;
  }
}

// Launches of one bfloat16 backward call that wants every gradient: g_att,
// the attention backward (2, or 3 where blocks share a problem), dx or dy,
// both weight gradients in one launch, the column partials, [the LayerNorm
// backward's one,] one reduce_sums; -1 for a shape it refuses.
int vitta_attn_proj_bwd_bf16_launches(int b_, int n, int nh, int hd,
                                      int with_ln) {
  if (bad_dims_bf16(b_, n, nh, hd)) return -1;
  return 7 + (attn::bwd_split(b_, nh) > 1) + (with_ln != 0);
}

int vitta_attn_proj_bwd_bf16(const void* x, const void* qkv,
                             const void* wqkv, const void* wproj,
                             const float* bias, const float* mask,
                             const void* o_att, const float* ms,
                             const void* g, void* dx, void* dwqkv,
                             void* dbqkv, void* dwproj, void* dbproj,
                             float* dbias, float* scratch, int b_, int n,
                             int nh, int hd, int nw, float scale,
                             void* e_tap, void* stream) {
  return (int)backward_bf16(
      as_bf16(x), as_bf16(x), as_bf16(qkv), nullptr, as_bf16(wqkv),
      as_bf16(wproj), bias, mask, as_bf16(o_att), ms, as_bf16(g), nullptr,
      as_bf16(dx), nullptr, as_bf16(dwqkv), as_bf16(dbqkv), as_bf16(dwproj),
      as_bf16(dbproj), dbias, scratch, as_bf16(e_tap), b_, n, nh, hd, nw,
      0.f, scale, (cudaStream_t)stream);
}

int vitta_attn_ln_proj_bwd_bf16(const void* x, const void* y,
                                const void* qkv, const float* gamma,
                                const void* wqkv, const void* wproj,
                                const float* bias, const float* mask,
                                const void* o_att, const float* ms,
                                const void* g, const void* gy, void* dx,
                                float* dgb, void* dwqkv, void* dbqkv,
                                void* dwproj, void* dbproj, float* dbias,
                                float* scratch, int b_, int n, int nh, int hd,
                                int nw, float eps, float scale, void* e_tap,
                                void* stream) {
  if (gamma == nullptr || y == nullptr || dgb == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)backward_bf16(
      as_bf16(x), as_bf16(y), as_bf16(qkv), gamma, as_bf16(wqkv),
      as_bf16(wproj), bias, mask, as_bf16(o_att), ms, as_bf16(g),
      as_bf16(gy), as_bf16(dx), dgb, as_bf16(dwqkv), as_bf16(dbqkv),
      as_bf16(dwproj), as_bf16(dbproj), dbias, scratch, as_bf16(e_tap), b_,
      n, nh, hd, nw, eps, scale, (cudaStream_t)stream);
}

}  // extern "C"
