// The Video Swin MLP, forward and backward, with the LayerNorm in front of
// it (vitta_lnmlp_*) and without (vitta_mlp_*), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vitta_tpu/ops/pallas_mlp.py:
//   _lnmlp_fwd_kernel (:303) and its pipelined form (:386), launched by
//   _pallas_lnmlp_fwd (:523), and
//   _lnmlp_bwd_kernel (:322) and its pipelined form (:438), launched by
//   _pallas_lnmlp_bwd (:560); without the LayerNorm
//   _fwd_kernel (:138), launched by _pallas_mlp_fwd (:192), and
//   _bwd_kernel (:154), launched by _pallas_mlp_bwd (:222).
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
// column sums, and the LayerNorm backward (two launches).
//
// gemm_tiles, its epilogues (the bias, the GELU, the product with s, the sum
// with gy) and its launchers are in gemm_tiles.cuh, which also says how the
// weight gradients, sums over all M rows, are split over blockIdx.z and
// added in a fixed order.  db1, db2, dgamma and dbeta are summed the same
// way (reduce.cuh).
//
// At bfloat16 (vitta_lnmlp_{fwd,bwd}_bf16 and vitta_mlp_{fwd,bwd}_bf16,
// the Pallas kernels at the compute dtype) the six products run on
// gemm_wgmma_bf16 (gemm_wgmma_bf16.cuh: wgmma fed by TMA, a fresh float32
// sum per 64-deep slice, each value rounded once in the epilogue), each
// cut by its own plan (bf16_plan), db1 is summed in the dh product's
// epilogue, dw1 and dw2 share one launch, and where a weight gradient's
// plan cuts K its chunks are added in order by reduce_partials, which
// rounds once.  The MLP without the LayerNorm (pallas_mlp.py:138-183) at
// Video Swin-T's and Swin-S's widths (C 48, 96 or 192, F = 4C:
// mlp_fused) runs on mlp_fused_bf16.cuh: the forward in one launch that
// keeps a on chip (writing a and s only for the backward), the backward as
// one row pass (dh, dhc, dx, the bias gradients' column sums, two rows a
// block), dw1 and dw2 in one launch of the core, and one reduce_sums
// launch that adds the bias gradients' rows and the weight gradients'
// chunks in order: 3 launches.  At other widths it runs the
// LayerNorm-MLP's products on x: forward h and o, 2 launches; backward dh
// with db1's partials and their sum, dx = dhc w1 rounded in its epilogue
// (no gy, no LayerNorm backward behind it), the weight gradients, db2's
// column sums: 6 launches, 7-8 where a gradient's K is cut.
//
// Without the LayerNorm (the widths that are no multiple of 128: Video
// Swin-T's and Swin-S's 96 and 192) the same products run on x itself:
// forward launches 2 and 3 above on x, o = gelu(x w1^T + b1) w2^T + b2;
// backward dh = (g w2) * s, dx = dh w1, dw1 = dh^T x, dw2 = g^T a and the two
// column sums, with no LayerNorm launch before or behind.  96 and 384 are no
// multiples of the 128 x 128 tile: gemm_tiles masks the ragged edge, so a
// quarter of the edge tiles' multiply-adds are spent on zeros.

#include <cuda_runtime.h>

#include "gemm_tiles.cuh"
#include "gemm_wgmma_bf16.cuh"
#include "ln_rows.cuh"
#include "mlp_fused_bf16.cuh"

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

// The plain MLP backward's scratch: dh (m, f), the partial weight-gradient
// products, the partial column sums.
struct MlpBwdScratch {
  long long dh, grad, cols;
  long long total() const { return dh + grad + cols; }
};

MlpBwdScratch mlp_bwd_scratch(int m, int c, int f) {
  MlpBwdScratch s;
  s.dh = (long long)m * f;
  s.grad = max2(grad_partial_floats(f, c, m), grad_partial_floats(c, f, m));
  s.cols = (long long)vitta::col_chunks(m) * f;
  return s;
}

bool bad_dims(int m, int c, int f) {
  return m <= 0 || c <= 0 || f <= 0 || c % 4 != 0 || f % 4 != 0 ||
         (m + 63) / 64 > 65535;
}

// The six bfloat16 products, as the entries below run them.
constexpr int kH = 0, kO = 1, kDh = 2, kDy = 3, kDw1 = 4, kDw2 = 5;
constexpr int kProducts = 6;

// A product's extents: C (M, N) over K, A (a_rows, a_cols) and B
// (b_rows, b_cols) as they lie in device memory.
struct Dims {
  int M, N, K;
  long long a_rows, a_cols, b_rows, b_cols;
};

Dims product_dims(int which, int m, int c, int f) {
  switch (which) {
    case kH:   return Dims{m, f, c, m, c, f, c};    // y w1^T
    case kO:   return Dims{m, c, f, m, f, c, f};    // a w2^T
    case kDh:  return Dims{m, f, c, m, c, c, f};    // go w2
    case kDy:  return Dims{m, c, f, m, f, f, c};    // dhc w1
    case kDw1: return Dims{f, c, m, m, f, m, c};    // dhc^T y
    default:   return Dims{c, f, m, m, c, m, f};    // go^T a
  }
}

bool is_grad(int which) { return which == kDw1 || which == kDw2; }

// A product's plan.  The two weight gradients share one launch: their
// chunks of K are cut for the tiles of both, and both report its grid.
WgPlan bf16_plan(int which, int m, int c, int f) {
  const Dims d = product_dims(which, m, c, f);
  if (!is_grad(which)) return wg_row_plan(d.M, d.N, d.K, sm_count());
  const Dims o = product_dims(which == kDw1 ? kDw2 : kDw1, m, c, f);
  const long long tiles = wg_grad_tiles(d.M, d.N) + wg_grad_tiles(o.M, o.N);
  WgPlan p = wg_grad_plan(d.M, d.N, d.K, tiles, sm_count());
  const int work =
      p.work + wg_grad_plan(o.M, o.N, o.K, tiles, sm_count()).work;
  const int slots = (p.bm == 64 ? 2 : 1) * sm_count();
  p.grid = work < slots ? work : slots;
  return p;
}

// The float32 partials a product writes: a weight gradient's chunks where
// its plan cuts K (one chunk is rounded in the epilogue), a row product's
// likewise (VITTA_WG_ROW_SPLIT), else dh's column sums per 64 rows.
long long product_scratch_floats(int which, int m, int c, int f) {
  const Dims d = product_dims(which, m, c, f);
  const WgPlan p = bf16_plan(which, m, c, f);
  if (p.splits > 1) return (long long)p.splits * d.M * d.N;
  return which == kDh ? colsum_partials(m) * f : 0;
}

// Weight gradient `which` as wgmma_grads takes it.
WgGrad grad_job(int which, const CUtensorMap& ta, const CUtensorMap& tb,
                bf16* out, float* partial, int m, int c, int f) {
  const Dims d = product_dims(which, m, c, f);
  return WgGrad{&ta, &tb, d.M, d.N, d.K, bf16_plan(which, m, c, f), out,
                partial};
}

// A weight gradient's chunks, where its plan cuts K, added in order into
// its output and rounded once.
cudaError_t grad_sums(const WgGrad& g, cudaStream_t st) {
  if (g.plan.splits == 1) return cudaSuccess;
  return launch_reduce_partials(g.partial, g.out, g.plan.splits,
                                (long long)g.M * g.N, st);
}

// Product `which` on the operands behind ta and tb: the row products'
// epilogues write `out` (dh's also its column sums per 64 rows to
// `colsum`, where it is not null); a weight gradient goes to grad_out,
// through its chunks' partials at `partial` where its plan cuts K (then two
// launches).  A row product cut into chunks needs `partial` too, and is
// refused without it.
cudaError_t run_product(int which, const CUtensorMap& ta,
                        const CUtensorMap& tb, const bf16* bias,
                        const bf16* aux, const Bf16Out& out, float* partial,
                        bf16* grad_out, int m, int c, int f, cudaStream_t st,
                        float* colsum = nullptr) {
  const Dims d = product_dims(which, m, c, f);
  const WgPlan p = bf16_plan(which, m, c, f);
  if (which < kDw1 && p.splits > 1 && partial == nullptr)
    return cudaErrorNotSupported;
  switch (which) {
    case kH:
      return wgmma_product<false, false, EPI_GELU>(ta, tb, bias, nullptr, out,
                                                   partial, d.M, d.N, d.K, p,
                                                   st);
    case kO:
      return wgmma_product<false, false, EPI_BIAS>(ta, tb, bias, nullptr, out,
                                                   partial, d.M, d.N, d.K, p,
                                                   st);
    case kDh:
      return wgmma_product<false, true, EPI_MUL>(ta, tb, nullptr, aux, out,
                                                 partial, d.M, d.N, d.K, p,
                                                 st, colsum);
    case kDy:
      return wgmma_product<false, true, EPI_ADD>(ta, tb, nullptr, aux, out,
                                                 partial, d.M, d.N, d.K, p,
                                                 st);
    default: {
      const WgGrad g = grad_job(which, ta, tb, grad_out, partial, m, c, f);
      const cudaError_t e = wgmma_grads(g, nullptr, st);
      return e != cudaSuccess ? e : grad_sums(g, st);
    }
  }
}

const bf16* as_bf16(const void* p) { return reinterpret_cast<const bf16*>(p); }

// The bfloat16 backward's scratch, in floats and in this order: dh (m, f)
// float32, dhc (m, f) bfloat16, dy (m, c) float32, the LayerNorm
// backward's, the weight gradients' float32 partials (dw1's, then dw2's,
// where their plans cut K), the partial column sums of db1 and then of
// db2.  Without the LayerNorm (ln false) there is no dh, dy or LayerNorm
// part: dhc comes first, and the column partials of db1 and db2 lie one
// after the other in one region (the fused row pass writes both at once).
struct Bf16BwdScratch {
  long long dh, dhc, dy, ln, grad, cols;
  long long total() const { return dh + dhc + dy + ln + grad + cols; }
};

Bf16BwdScratch bf16_bwd_scratch(int m, int c, int f, bool ln = true) {
  Bf16BwdScratch s;
  s.dh = ln ? (long long)m * f : 0;
  s.dhc = ((long long)m * f / 2 + 3) / 4 * 4;
  s.dy = ln ? (long long)m * c : 0;
  s.ln = ln ? (vitta::ln_bwd_scratch_floats(m, c) + 3) / 4 * 4 : 0;
  s.grad = product_scratch_floats(kDw1, m, c, f) +
           product_scratch_floats(kDw2, m, c, f);
  // db1's column partials (the dh product's, a row per 64 rows), then
  // db2's (col_sums of go), one after the other; without the LayerNorm
  // both at once: colsum_partials(m) rows of each at other widths
  // (col_chunks(m) <= colsum_partials(m)), the fused row pass's two a
  // block, 2 min(cdiv(m, 128), SMs)
  s.cols = ln ? max2(colsum_partials(m) * f,
                     (long long)vitta::col_chunks(m) * c)
              : max2(colsum_partials(m), 2 * cdiv(m, kMfRows)) * (f + c);
  return s;
}

// bfloat16: every extent a multiple of 8 (16-byte rows of 8 values)
bool bad_dims_bf16(int m, int c, int f) {
  return bad_dims(m, c, f) || c % 8 != 0 || f % 8 != 0;
}

// The bfloat16 forward's two products on `in` (m, c), the LayerNorm's y
// or x itself: a (and s where it is not null) = gelu(in w1^T + b1), then
// o = a w2^T + b2, each rounded once in its epilogue.
cudaError_t fwd_products_bf16(const bf16* in, const void* w1, const void* b1,
                              const void* w2, const void* b2, bf16* a,
                              bf16* s, bf16* o, int m, int c, int f,
                              cudaStream_t st) {
  CUtensorMap mi, mw1, ma, mw2;
  if (!make_map(&mi, in, m, c) || !make_map(&mw1, as_bf16(w1), f, c) ||
      !make_map(&ma, a, m, f) || !make_map(&mw2, as_bf16(w2), c, f))
    return cudaErrorInvalidValue;
  const cudaError_t e =
      run_product(kH, mi, mw1, as_bf16(b1), nullptr, Bf16Out{nullptr, a, s},
                  nullptr, nullptr, m, c, f, st);
  if (e != cudaSuccess) return e;
  return run_product(kO, ma, mw2, as_bf16(b2), nullptr,
                     Bf16Out{nullptr, o, nullptr}, nullptr, nullptr, m, c, f,
                     st);
}

// The bfloat16 backward's products and sums on the forward's input `in`
// (y, or x itself), in launch order: dh = (go w2) * s into dh_out (dhc,
// and float32 dh where dh_out.f is not null) with its column partials per
// 64 rows, added in order into db1; the product of dhc and w1 into row_out
// (+ gy where it is not null: float32 dy for the LayerNorm backward, or
// bfloat16 dx); dw1 = dhc^T in and dw2 = go^T a in one launch, each
// rounded once, in its epilogue or, where its plan cuts K into chunks, by
// the ordered sum of their partials; db2 = the column sums of go.
cudaError_t bwd_products_bf16(const bf16* in, const bf16* a, const bf16* s,
                              const bf16* go, const bf16* gy, const bf16* w1,
                              const bf16* w2, const Bf16Out& dh_out,
                              const Bf16Out& row_out, bf16* dw1, bf16* db1,
                              bf16* dw2, bf16* db2, float* grad, float* cols,
                              int m, int c, int f, cudaStream_t st) {
  CUtensorMap mgo, mw2, mdhc, mw1, mi, ma;
  if (!make_map(&mgo, go, m, c) || !make_map(&mw2, w2, c, f) ||
      !make_map(&mdhc, dh_out.b, m, f) || !make_map(&mw1, w1, f, c) ||
      !make_map(&mi, in, m, c) || !make_map(&ma, a, m, f))
    return cudaErrorInvalidValue;
  cudaError_t e = run_product(kDh, mgo, mw2, nullptr, s, dh_out, nullptr,
                              nullptr, m, c, f, st, cols);
  if (e != cudaSuccess) return e;
  e = launch_reduce_partials(cols, db1, (int)colsum_partials(m),
                             (long long)f, st);
  if (e != cudaSuccess) return e;
  e = run_product(kDy, mdhc, mw1, nullptr, gy, row_out, nullptr, nullptr, m,
                  c, f, st);
  if (e != cudaSuccess) return e;
  const WgGrad g1 = grad_job(kDw1, mdhc, mi, dw1, grad, m, c, f);
  const WgGrad g2 = grad_job(kDw2, mgo, ma, dw2,
                             grad + product_scratch_floats(kDw1, m, c, f), m,
                             c, f);
  e = wgmma_grads(g1, &g2, st);
  if (e != cudaSuccess) return e;
  e = grad_sums(g1, st);
  if (e != cudaSuccess) return e;
  e = grad_sums(g2, st);
  if (e != cudaSuccess) return e;
  return vitta::launch_col_sums(go, cols, db2, m, c, st);
}

// The fused forward (mlp_fused(c, f)): o, and a and s where they are not
// null (both or neither), in one launch.
cudaError_t fwd_fused_bf16(const bf16* x, const bf16* w1, const bf16* b1,
                           const bf16* w2, const bf16* b2, bf16* a, bf16* s,
                           bf16* o, int m, int c, int f, cudaStream_t st) {
  if ((a == nullptr) != (s == nullptr)) return cudaErrorInvalidValue;
  CUtensorMap mx, mw1, mw2, ma, ms;
  if (!make_map(&mx, x, m, c) || !make_map(&mw1, w1, f, c) ||
      !make_map(&mw2, w2, c, f))
    return cudaErrorInvalidValue;
  const bool res = a != nullptr;
  if (res && (!make_map(&ma, a, m, f) || !make_map(&ms, s, m, f)))
    return cudaErrorInvalidValue;
  const MfArgs args{b1, b2, o, nullptr, nullptr, nullptr, m, f, res ? 1 : 0};
  // without residuals the two store maps are never read
  return launch_mlp_rows_c<false>(c, mx, mw1, mw2, res ? ma : mx,
                                  res ? ms : mx, args, st);
}

// The fused backward (mlp_fused(c, f)): the row pass (dhc at the scratch's
// start, dx, the column partials of dh and g), dw1 and dw2 in one launch
// of the core, and one ordered reduce of db1's and db2's partials and of
// the weight gradients' chunks where their plans cut K.
cudaError_t bwd_fused_bf16(const bf16* x, const bf16* a, const bf16* s,
                           const bf16* g, const bf16* w1, const bf16* w2,
                           bf16* dx, bf16* dw1, bf16* db1, bf16* dw2,
                           bf16* db2, float* scratch, float* dh_tap, int m,
                           int c, int f, cudaStream_t st) {
  const Bf16BwdScratch sz = bf16_bwd_scratch(m, c, f, false);
  bf16* dhc = reinterpret_cast<bf16*>(scratch);
  float* grad = scratch + sz.dhc;
  float* part1 = grad + sz.grad;
  // a row of partials a warpgroup of each persistent block
  const int tiles = (m + kMfRows - 1) / kMfRows;
  const long long blocks = 2LL * (tiles < sm_count() ? tiles : sm_count());
  float* part2 = part1 + blocks * f;
  CUtensorMap mg, mw1, mw2, ms, mdhc, mx, ma;
  if (!make_map(&mg, g, m, c) || !make_map(&mw1, w1, f, c) ||
      !make_map(&mw2, w2, c, f) || !make_map(&ms, s, m, f) ||
      !make_map(&mdhc, dhc, m, f) || !make_map(&mx, x, m, c) ||
      !make_map(&ma, a, m, f))
    return cudaErrorInvalidValue;
  const MfArgs args{nullptr, nullptr, dx, dh_tap, part1, part2, m, f, 0};
  cudaError_t e = launch_mlp_rows_c<true>(c, mg, mw1, mw2, ms, mdhc, args, st);
  if (e != cudaSuccess) return e;
  const WgGrad g1 = grad_job(kDw1, mdhc, mx, dw1, grad, m, c, f);
  const WgGrad g2 = grad_job(kDw2, mg, ma, dw2,
                             grad + product_scratch_floats(kDw1, m, c, f), m,
                             c, f);
  e = wgmma_grads(g1, &g2, st);
  if (e != cudaSuccess) return e;
  PartialSums sums;
  sums.add(part1, f, db1, (int)blocks, f);
  sums.add(part2, c, db2, (int)blocks, c);
  for (const WgGrad* gr : {&g1, &g2})
    if (gr->plan.splits > 1)
      sums.add(gr->partial, (long long)gr->M * gr->N, gr->out,
               gr->plan.splits, (long long)gr->M * gr->N);
  return launch_reduce_sums(sums, st);
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
  // the column sums' grid is (.., col_chunks(m)); the LayerNorm backward
  // takes c up to kLnBwdMaxC
  if (bad_dims(m, c, f) || vitta::col_chunks(m) > 65535 ||
      c > vitta::kLnBwdMaxC)
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
  return (int)vitta::launch_ln_bwd(x, gamma, dy, dx, dgb, ln, m, c, eps,
                                   vitta::ln_bwd_vec_ok(x, gamma, dy, dx, c),
                                   st);
}

// The MLP without the LayerNorm.  x, o: (m, c); w1 (f, c); w2 (c, f);
// a: (m, f), always written (it passes through device memory between the two
// products); s: (m, f) or null.
int vitta_mlp_fwd(const float* x, const float* w1, const float* b1,
                  const float* w2, const float* b2, float* a, float* s,
                  float* o, int m, int c, int f, void* stream) {
  if (bad_dims(m, c, f)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e =
      launch_gemm<false, EPI_GELU>(x, w1, b1, nullptr, a, s, m, f, c, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_gemm<false, EPI_BIAS>(a, w2, b2, nullptr, o, nullptr, m,
                                           c, f, st);
}

// Floats of scratch vitta_mlp_bwd needs.
long long vitta_mlp_bwd_scratch_floats(int m, int c, int f) {
  if (bad_dims(m, c, f)) return -1;
  return mlp_bwd_scratch(m, c, f).total();
}

// x, g, dx: (m, c); a, s: (m, f); w1, dw1: (f, c); w2, dw2: (c, f); db1: (f);
// db2: (c).
int vitta_mlp_bwd(const float* x, const float* a, const float* s,
                  const float* g, const float* w1, const float* w2, float* dx,
                  float* dw1, float* db1, float* dw2, float* db2,
                  float* scratch, int m, int c, int f, void* stream) {
  if (bad_dims(m, c, f) || vitta::col_chunks(m) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const MlpBwdScratch sz = mlp_bwd_scratch(m, c, f);
  float* dh = scratch;
  float* grad = dh + sz.dh;
  float* cols = grad + sz.grad;
  // dh = (g w2) * s, then dx = dh w1
  cudaError_t e = launch_gemm<true, EPI_MUL>(g, w2, nullptr, s, dh, nullptr,
                                             m, f, c, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<true, EPI_ADD>(dh, w1, nullptr, nullptr, dx, nullptr, m, c,
                                 f, st);
  if (e != cudaSuccess) return (int)e;
  // dw1 = dh^T x, dw2 = g^T a, over all m rows
  e = launch_grad_gemm(dh, x, dw1, grad, f, c, m, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_grad_gemm(g, a, dw2, grad, c, f, m, st);
  if (e != cudaSuccess) return (int)e;
  e = vitta::launch_col_sums(dh, cols, db1, m, f, st);
  if (e != cudaSuccess) return (int)e;
  return (int)vitta::launch_col_sums(g, cols, db2, m, c, st);
}

// ------------------------------------------------------------- bfloat16
// The same forward and backward at bfloat16 (the header says where they
// round): x, y, a, s, o, w1, b1, w2, b2, go, gy, dx, dw1, db1, dw2, db2
// bfloat16, gamma, beta, dgb and the scratch float32.  Every bfloat16 and
// float32 pointer must be 16-byte aligned and c and f multiples of 8:
// anything else is refused (cudaErrorMisalignedAddress / InvalidValue).
// The six products run on gemm_wgmma_bf16 (gemm_wgmma_bf16.cuh), each by
// its plan (bf16_plan); the entries encode one tensor map per operand
// tensor, before their first launch.

int vitta_lnmlp_fwd_bf16(const void* x, const float* gamma, const float* beta,
                         const void* w1, const void* b1, const void* w2,
                         const void* b2, void* y, void* a, void* s, void* o,
                         int m, int c, int f, float eps, void* stream) {
  if (bad_dims_bf16(m, c, f)) return (int)cudaErrorInvalidValue;
  if (!all_aligned16({x, gamma, beta, w1, b1, w2, b2, y, a, s, o}))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  bf16* yb = reinterpret_cast<bf16*>(y);
  const cudaError_t e = vitta::launch_ln_rows(
      reinterpret_cast<const bf16*>(x), gamma, beta, yb, m, c, eps, st);
  if (e != cudaSuccess) return (int)e;
  return (int)fwd_products_bf16(yb, w1, b1, w2, b2, reinterpret_cast<bf16*>(a),
                                reinterpret_cast<bf16*>(s),
                                reinterpret_cast<bf16*>(o), m, c, f, st);
}

// Floats of scratch vitta_lnmlp_bwd_bf16 needs.
long long vitta_lnmlp_bwd_bf16_scratch_floats(int m, int c, int f) {
  if (bad_dims_bf16(m, c, f)) return -1;
  return bf16_bwd_scratch(m, c, f).total();
}

// Where vitta_lnmlp_bwd_bf16 leaves its intermediates in its scratch, in
// floats from its start: offsets[0] dh (m, f) float32, offsets[1] its
// rounded form dhc (m, f) bfloat16, offsets[2] dy (m, c) float32 (the
// layout the entry below uses); -1 each for dimensions it refuses.
void vitta_lnmlp_bwd_bf16_plan(int m, int c, int f, long long* offsets) {
  if (bad_dims_bf16(m, c, f)) {
    offsets[0] = offsets[1] = offsets[2] = -1;
    return;
  }
  const Bf16BwdScratch sz = bf16_bwd_scratch(m, c, f);
  offsets[0] = 0;
  offsets[1] = sz.dh;
  offsets[2] = sz.dh + sz.dhc;
}

// How the six products are cut on this card, in the order h, o, dh, dy,
// dw1, dw2: six ints each, the tile's rows and columns, the chunks of K,
// their length, the persistent grid and the block's dynamic shared memory
// in bytes (out: 36 ints); all -1 for dimensions the entries refuse.  The
// MLP without the LayerNorm (vitta_mlp_*_bf16) cuts its products the same
// way: it runs them on x where these run them on y (dy is its dx).
void vitta_lnmlp_bf16_plan(int m, int c, int f, int* out) {
  for (int which = 0; which < kProducts; ++which) {
    int* q = out + 6 * which;
    if (bad_dims_bf16(m, c, f)) {
      q[0] = q[1] = q[2] = q[3] = q[4] = q[5] = -1;
      continue;
    }
    const WgPlan p = bf16_plan(which, m, c, f);
    q[0] = p.bm, q[1] = p.bn, q[2] = p.splits, q[3] = p.kchunk, q[4] = p.grid;
    q[5] = p.bm == 64    ? WgShape<64, 128, kStages64>::smem
           : p.bn == 256 ? WgShape<128, 256, 3>::smem
                         : WgShape<128, 128, kStages128>::smem;
  }
}

int vitta_lnmlp_bwd_bf16(const void* x, const void* y, const void* a,
                         const void* s, const void* go, const void* gy,
                         const float* gamma, const void* w1, const void* w2,
                         void* dx, float* dgb, void* dw1, void* db1,
                         void* dw2, void* db2, float* scratch, int m, int c,
                         int f, float eps, void* stream) {
  if (bad_dims_bf16(m, c, f) || vitta::col_chunks(m) > 65535 ||
      c > vitta::kLnBwdMaxC)
    return (int)cudaErrorInvalidValue;
  if (!all_aligned16({x, y, a, s, go, gy, gamma, w1, w2, dx, dgb, dw1, db1,
                      dw2, db2, scratch}))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const Bf16BwdScratch sz = bf16_bwd_scratch(m, c, f);
  float* dh = scratch;
  bf16* dhc = reinterpret_cast<bf16*>(dh + sz.dh);
  float* dy = dh + sz.dh + sz.dhc;
  float* ln = dy + sz.dy;
  float* grad = ln + sz.ln;
  float* cols = grad + sz.grad;
  // dh float32 and rounded, then dy = dhc w1 + gy, float32, which the
  // LayerNorm backward reads
  cudaError_t e = bwd_products_bf16(
      as_bf16(y), as_bf16(a), as_bf16(s), as_bf16(go), as_bf16(gy),
      as_bf16(w1), as_bf16(w2), Bf16Out{dh, dhc, nullptr},
      Bf16Out{dy, nullptr, nullptr}, reinterpret_cast<bf16*>(dw1),
      reinterpret_cast<bf16*>(db1), reinterpret_cast<bf16*>(dw2),
      reinterpret_cast<bf16*>(db2), grad, cols, m, c, f, st);
  if (e != cudaSuccess) return (int)e;
  const bf16* xb = reinterpret_cast<const bf16*>(x);
  bf16* dxb = reinterpret_cast<bf16*>(dx);
  return (int)vitta::launch_ln_bwd(xb, gamma, (const float*)dy, dxb, dgb, ln,
                                   m, c, eps,
                                   vitta::ln_bwd_vec_ok(xb, gamma,
                                                        (const float*)dy, dxb,
                                                        c),
                                   st);
}

// The fused kernels' plan at (m, c, f), 13 ints: fused (1 or 0; the rest
// -1 where 0), a tile's rows, a chunk's columns of F, the tiles, the
// persistent grid; the forward's slots of its rings A, S (0), B and its
// dynamic shared memory in bytes; the backward row pass's.
void vitta_mlp_bf16_rows_plan(int m, int c, int f, int* out) {
  const bool ok = !bad_dims_bf16(m, c, f) && mlp_fused(c, f);
  out[0] = ok ? 1 : 0;
  for (int i = 1; i < 13; ++i) out[i] = -1;
  if (!ok) return;
  const int tiles = (m + kMfRows - 1) / kMfRows;
  out[1] = kMfRows, out[2] = kMfChunk, out[3] = tiles;
  out[4] = tiles < sm_count() ? tiles : sm_count();
  mlp_rows_shape<false>(c, out + 5);
  mlp_rows_shape<true>(c, out + 9);
}

// The MLP without the LayerNorm at bfloat16 (x, w1, b1, w2, b2, a, s, o, g,
// dx, dw1, db1, dw2, db2 bfloat16; dh_tap and the scratch float32; every
// pointer 16-byte aligned and c and f multiples of 8, as above).  Forward:
// x, o (m, c); a and s (m, f), both or neither: the fused kernel (one
// launch) writes them only where given; at other widths a is always
// written (it passes between the two products) and s may be null.
int vitta_mlp_fwd_bf16(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* a, void* s,
                       void* o, int m, int c, int f, void* stream) {
  if (bad_dims_bf16(m, c, f)) return (int)cudaErrorInvalidValue;
  if (!all_aligned16({x, w1, b1, w2, b2, a, s, o}))
    return (int)cudaErrorMisalignedAddress;
  if (mlp_fused(c, f))
    return (int)fwd_fused_bf16(as_bf16(x), as_bf16(w1), as_bf16(b1),
                               as_bf16(w2), as_bf16(b2),
                               reinterpret_cast<bf16*>(a),
                               reinterpret_cast<bf16*>(s),
                               reinterpret_cast<bf16*>(o), m, c, f,
                               (cudaStream_t)stream);
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fwd_products_bf16(as_bf16(x), w1, b1, w2, b2,
                                reinterpret_cast<bf16*>(a),
                                reinterpret_cast<bf16*>(s),
                                reinterpret_cast<bf16*>(o), m, c, f,
                                (cudaStream_t)stream);
}

// Floats of scratch vitta_mlp_bwd_bf16 needs: dhc (m, f) bfloat16 at its
// start, then the weight gradients' partials and the column partials.
long long vitta_mlp_bwd_bf16_scratch_floats(int m, int c, int f) {
  if (bad_dims_bf16(m, c, f)) return -1;
  return bf16_bwd_scratch(m, c, f, false).total();
}

// Launches of one vitta_mlp_bwd_bf16 call: fused, the row pass, both weight
// gradients and one reduce; else dh, db1's ordered sum, dx, both weight
// gradients, one ordered sum for each whose plan cuts K, db2's column sums
// (two); -1 for dimensions it refuses.
int vitta_mlp_bwd_bf16_launches(int m, int c, int f) {
  if (bad_dims_bf16(m, c, f)) return -1;
  if (mlp_fused(c, f)) return 3;
  return 6 + (bf16_plan(kDw1, m, c, f).splits > 1) +
         (bf16_plan(kDw2, m, c, f).splits > 1);
}

// Backward: x, g, dx (m, c); a, s (m, f); w1, dw1 (f, c); w2, dw2 (c, f);
// db1 (f); db2 (c); dh_tap (m, f) float32 or null: where it is not null the
// dh product also writes the float32 dh there (for a check; dhc is at the
// scratch's start).  dx = dhc w1 is rounded once.
int vitta_mlp_bwd_bf16(const void* x, const void* a, const void* s,
                       const void* g, const void* w1, const void* w2,
                       void* dx, void* dw1, void* db1, void* dw2, void* db2,
                       float* scratch, float* dh_tap, int m, int c, int f,
                       void* stream) {
  if (bad_dims_bf16(m, c, f) || vitta::col_chunks(m) > 65535)
    return (int)cudaErrorInvalidValue;
  if (!all_aligned16({x, a, s, g, w1, w2, dx, dw1, db1, dw2, db2, scratch,
                      dh_tap}))
    return (int)cudaErrorMisalignedAddress;
  if (mlp_fused(c, f))
    return (int)bwd_fused_bf16(
        as_bf16(x), as_bf16(a), as_bf16(s), as_bf16(g), as_bf16(w1),
        as_bf16(w2), reinterpret_cast<bf16*>(dx),
        reinterpret_cast<bf16*>(dw1), reinterpret_cast<bf16*>(db1),
        reinterpret_cast<bf16*>(dw2), reinterpret_cast<bf16*>(db2), scratch,
        dh_tap, m, c, f, (cudaStream_t)stream);
  const Bf16BwdScratch sz = bf16_bwd_scratch(m, c, f, false);
  bf16* dhc = reinterpret_cast<bf16*>(scratch);
  float* grad = scratch + sz.dhc;
  float* cols = grad + sz.grad;
  return (int)bwd_products_bf16(
      as_bf16(x), as_bf16(a), as_bf16(s), as_bf16(g), nullptr, as_bf16(w1),
      as_bf16(w2), Bf16Out{dh_tap, dhc, nullptr},
      Bf16Out{nullptr, reinterpret_cast<bf16*>(dx), nullptr},
      reinterpret_cast<bf16*>(dw1), reinterpret_cast<bf16*>(db1),
      reinterpret_cast<bf16*>(dw2), reinterpret_cast<bf16*>(db2), grad, cols,
      m, c, f, (cudaStream_t)stream);
}

// Floats of scratch vitta_lnmlp_bf16_product needs for product `which`.
long long vitta_lnmlp_bf16_product_scratch_floats(int which, int m, int c,
                                                  int f) {
  if (bad_dims_bf16(m, c, f) || which < 0 || which >= kProducts) return -1;
  return product_scratch_floats(which, m, c, f);
}

// One of the six products alone, by the plan the entries use, for timing
// and checks (chip_smoke.py phase 21, tools/gemm_variants.py); the port's
// path does not call it.  which: 0 h, 1 o, 2 dh, 3 dy, 4 dw1, 5 dw2.  A and
// B as that product reads them: h y (m, c), w1 (f, c); o a (m, f), w2
// (c, f); dh go (m, c), w2; dy dhc (m, f), w1; dw1 dhc, y (m, c); dw2 go,
// a.  bias b1 (h) or b2 (o); aux s (dh) or gy (dy, may be null).  out_f
// float32 dh or dy; out_b bfloat16 a (h), o, dhc (dh), dw1 or dw2; out_s s
// (h, may be null).  partial: the floats the entry above names (dh also
// writes its column sums there, as the backward does).
int vitta_lnmlp_bf16_product(int which, const void* A, const void* B,
                             const void* bias, const void* aux, float* out_f,
                             void* out_b, void* out_s, float* partial, int m,
                             int c, int f, void* stream) {
  if (bad_dims_bf16(m, c, f) || which < 0 || which >= kProducts)
    return (int)cudaErrorInvalidValue;
  if (!all_aligned16({A, B, bias, aux, out_f, out_b, out_s, partial}))
    return (int)cudaErrorMisalignedAddress;
  const Dims d = product_dims(which, m, c, f);
  CUtensorMap ta, tb;
  if (!make_map(&ta, as_bf16(A), d.a_rows, d.a_cols) ||
      !make_map(&tb, as_bf16(B), d.b_rows, d.b_cols))
    return (int)cudaErrorInvalidValue;
  const bool grad = is_grad(which);
  const bool sums = which == kDh && bf16_plan(which, m, c, f).splits == 1;
  bf16* ob = reinterpret_cast<bf16*>(out_b);
  return (int)run_product(
      which, ta, tb, as_bf16(bias), as_bf16(aux),
      grad ? Bf16Out{} : Bf16Out{out_f, ob, reinterpret_cast<bf16*>(out_s)},
      partial, grad ? ob : nullptr, m, c, f, (cudaStream_t)stream,
      sums ? partial : nullptr);
}

}  // extern "C"
