// Window attention, forward and backward, for Video Swin, for Hopper
// (sm_90a): on the packed projection output (vitta_attn_packed_*) and per
// (head, window) on separate q, k, v (vitta_attn_heads_*).
//
// Replaces the Pallas TPU kernels of vitta_tpu/ops/pallas_attention.py:
//   _packed_fwd_kernel (:448) with its head loop _heads_fwd (:403),
//   launched by _packed_attn_fwd (:556), and
//   _packed_bwd_kernel (:517) with its head loop _heads_bwd (:457) and
//   _dbias_accum (:384), launched by _packed_attn_bwd (:598); per (head,
//   window) _fwd_kernel (:83), launched by _pallas_attn_fwd (:140), and
//   _bwd_kernel (:91), launched by _pallas_attn_bwd (:161).
//
// Forward.
//
// What it computes, per window b and head h, on the packed projection
// output qkv (B_, N, 3C) whose last axis is ordered (3, nh, hd):
//   l   = scale * q k^T + bias[h] + mask[b mod nW]        (N, N) float32
//   out = softmax(l) v                                    written (B_, N, C)
// and, on request, each row's softmax maximum and sum (B_, N, 2nh), which a
// backward reads instead of reducing again.  The bias is taken dense
// (nh, N, N) or as Toeplitz slices (nh, 2wd-1, hw, hw); bias_at() is the one
// place that knows the difference.
//
// What bounds it: float32 operations (4*N*N*hd per problem against about
// 12*N*hd bytes of q, k, v and out), and inside the SM the shared-memory
// loads that feed them.  The TPU kernel handles one window per grid step and
// loops over the heads; here a block of 16 warps owns one (window, head)
// problem, or a share of its query rows where whole problems would leave SMs
// without a block, and the (N, N) logits never exist anywhere:
//  * K (transposed, so that lanes walk keys without bank conflicts) and V of
//    the head are read from the packed tensor into shared memory, 104 KB at
//    N = 392, hd = 32; with the warps' strips below the block holds 213 KB,
//    which needs the opt-in above 48 KB and leaves one block to an SM, so
//    the 16 warps are all that hides its latencies (with 8 warps an H100
//    took about 1.5 times as long at every Swin-B stage);
//  * a warp takes four query rows at a time; each lane keeps the logits of
//    keys lane, lane+32, ... in registers (13 per row at N = 392, the tail
//    masked), so one K value loaded from shared memory feeds four rows;
//  * the softmax is the exact two-pass one, over registers and two shuffle
//    reductions.  A masked entry is -100, not -inf, and every row holds its
//    own unmasked diagonal, so no row's maximum is -inf and nothing is NaN;
//  * the unnormalised probabilities go through a per-warp shared-memory
//    strip so that p v reads them as broadcasts while lane d owns output
//    channel d; the division by the row sum is applied to the (N, hd) result.
// Limits: hd <= 32 and N <= 416 (13 keys per lane); the wrapper raises
// beyond them.
//
// Backward.  From (qkv, bias, mask, ms, g), with ms the forward's row
// maximum m and sum s and g the cotangent of out:
//   p  = exp(l - m) / s                  the same __expf as the forward
//   dv = p^T g         dp = g v^T        rs = rowsum(dp * p)
//   dl = p * (dp - rs)
//   dq = scale * dl k  dk = scale * dl^T q
//   dbias = sum over windows of dl, dense (nh, N, N) or collapsed onto the
//           Toeplitz slices (nh, 2wd-1, hw, hw), as the bias came in
// and dq, dk, dv are written packed, (B_, N, 3C), the layout of qkv.
//
// What bounds it: float32 operations again.  The TPU kernel holds one
// window's (N, N) logits per head in VMEM and adds dbias into a block that
// its sequential grid revisits.  Here nothing of size (N, N) fits a block,
// dq is a sum over keys and dk, dv are sums over query rows, so the work is
// two kernels that each recompute the logits, and no sum crosses a block:
//  * the query kernel: a block owns one (window, head), or a share of its
//    query rows; K and V lie transposed in shared memory (107 KB), a warp
//    takes a few query rows at a time with the lanes on the keys, exactly
//    as the forward does, and gets p, dp, rs and dl in registers.  It
//    writes dl (B_, nh, N, N) and rs to scratch and computes dq;
//  * the key kernel: a block owns the same problem by key rows; Q and g lie
//    transposed in shared memory, the lanes are on the query rows, p and dl
//    are recomputed from m, s and the rs of the first kernel, and dv and dk
//    follow.  It reads bias and mask by columns, which costs half of each
//    32-byte sector;
//  * dq, dk and dv are sums over the lanes' index.  Each lane sums its 13
//    columns for each of 32 (row, channel) pairs, and one butterfly of 31
//    shuffles (warp_transpose_sum) leaves pair L's total on lane L: no
//    second copy of K, V, Q or g in the other layout, which shared memory
//    has no room for;
//  * dbias: a third kernel adds the dl of all windows in the order of the
//    windows (and, for the compact form, of the block diagonal).  dl passes
//    through device memory once, 315 MB at Swin-B's first stage for two
//    clips.  Keeping dbias in registers over a loop over windows would
//    avoid that and costs 52 more registers per thread than there are.
// Seven products of N*N*hd multiply-adds where five are the least possible
// (the forward has two).  No atomics anywhere: every output is the same from
// run to run.  The mask has no gradient.
//
// Per (head, window).  The TPU kernel of this route takes q, k and v as three
// head-major tensors (nh, B_, N, hd), which costs a transposing copy of each
// in front and of the output behind, one grid step per (head, window), a
// dense bias only, and keeps no row maximum and sum: its backward rebuilds
// the softmax from q and k.  Here the device code above addresses q, k, v
// and their cotangents through a base pointer and three strides each
// (attention_kernels.cuh: Rows), so the same kernels read the three where
// they lie: as views of the packed projection output, as (B_, N, nh, hd)
// tensors of their own, or head-major; no transposing copy exists.  What
// the route keeps of its own:
//  * the forward writes no row maximum and sum, and nothing but
//    (q, k, v, bias, mask) is kept for the backward;
//  * the backward's first launch is the forward kernel with no output: it
//    rebuilds the maximum and sum (q k^T and the softmax's two passes, no
//    p v), bit for bit what the forward had, into scratch; then the query
//    kernel, the key kernel and the sum over the windows as above.  Eight
//    products of N*N*hd multiply-adds where five are the least possible;
//  * dq, dk, dv are three outputs, each (B_, N, nh, hd); dbias is dense.
//
// The kernels and their launchers are in attention_kernels.cuh, which
// attention_proj.cu includes too.

#include <cuda_runtime.h>

#include "attention_kernels.cuh"

extern "C" {

// The largest window and head size the kernel takes.
int vitta_attn_max_tokens() { return vitta::attn::kMaxTokens; }
int vitta_attn_max_head_dim() { return vitta::attn::kMaxHeadDim; }
// The largest stride, in floats, between two tokens of q, k or v.
long long vitta_attn_max_row_stride() { return vitta::attn::kMaxRowStride; }

// bias: dense (nh, n, n) when compact == 0, else (nh, 2wd-1, hw, hw) with
// wd*hw == n.  mask: (nw, n, n) or null.  ms: (b_, n, 2nh) or null.
int vitta_attn_packed_fwd(const float* qkv, const float* bias,
                          const float* mask, float* out, float* ms, int b_,
                          int n, int nh, int hd, int nw, int compact, int wd,
                          int hw, float scale, void* stream) {
  return (int)vitta::attn::launch_packed_fwd(qkv, bias, mask, out, ms, b_, n,
                                             nh, hd, nw, compact, wd, hw,
                                             scale, (cudaStream_t)stream);
}

// Floats of scratch vitta_attn_packed_bwd needs: dl (b_, nh, n, n) and rs
// (b_, nh, n).
long long vitta_attn_bwd_scratch_floats(int b_, int n, int nh) {
  return vitta::attn::bwd_scratch_floats(b_, n, nh);
}

// g: (b_, n, nh*hd), the cotangent of out; ms as the forward wrote it;
// dqkv: (b_, n, 3*nh*hd); dbias: in the bias's form.
int vitta_attn_packed_bwd(const float* qkv, const float* bias,
                          const float* mask, const float* ms, const float* g,
                          float* dqkv, float* dbias, float* scratch, int b_,
                          int n, int nh, int hd, int nw, int compact, int wd,
                          int hw, float scale, void* stream) {
  if (dbias == nullptr) return (int)cudaErrorInvalidValue;
  return (int)vitta::attn::launch_packed_bwd(
      qkv, bias, mask, ms, g, dqkv, dbias, scratch, b_, n, nh, hd, nw,
      compact, wd, hw, scale, (cudaStream_t)stream);
}

// Per (head, window), on separate q, k, v: element (b, i, h, d) of q lies at
// q[b*strides[0] + i*strides[1] + h*strides[2] + d], of k and v likewise
// with strides[3..5] and strides[6..8] (a host array of 9).  bias: dense
// (nh, n, n).  mask: (nw, n, n) or null.  out: (b_, n, nh, hd).
int vitta_attn_heads_fwd(const float* q, const float* k, const float* v,
                         const long long* strides, const float* bias,
                         const float* mask, float* out, int b_, int n, int nh,
                         int hd, int nw, float scale, void* stream) {
  using vitta::attn::InRows;
  const long long* s = strides;
  return (int)vitta::attn::launch_fwd(
      InRows{q, s[0], s[1], s[2]}, InRows{k, s[3], s[4], s[5]},
      InRows{v, s[6], s[7], s[8]}, bias, mask, out, nullptr, b_, n, nh, hd, nw,
      0, 0, 0, scale, (cudaStream_t)stream);
}

// Floats of scratch vitta_attn_heads_bwd needs: the packed backward's and the
// rebuilt row maximum and sum (b_, n, 2nh).
long long vitta_attn_heads_bwd_scratch_floats(int b_, int n, int nh) {
  return vitta::attn::bwd_scratch_floats(b_, n, nh) + (long long)b_ * n * 2 * nh;
}

// g: (b_, n, nh, hd), the cotangent of out; dq, dk, dv: (b_, n, nh, hd),
// contiguous; dbias: (nh, n, n).
int vitta_attn_heads_bwd(const float* q, const float* k, const float* v,
                         const long long* strides, const float* bias,
                         const float* mask, const float* g, float* dq,
                         float* dk, float* dv, float* dbias, float* scratch,
                         int b_, int n, int nh, int hd, int nw, float scale,
                         void* stream) {
  using vitta::attn::InRows;
  using vitta::attn::OutRows;
  if (dbias == nullptr) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const InRows qr{q, s[0], s[1], s[2]}, kr{k, s[3], s[4], s[5]},
      vr{v, s[6], s[7], s[8]};
  const long long c = (long long)nh * hd;
  float* ms = scratch + vitta::attn::bwd_scratch_floats(b_, n, nh);
  cudaError_t e = vitta::attn::launch_fwd(qr, kr, vr, bias, mask, nullptr, ms,
                                          b_, n, nh, hd, nw, 0, 0, 0, scale,
                                          (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)vitta::attn::launch_bwd(
      qr, kr, vr, bias, mask, ms, g, OutRows{dq, n * c, c, hd},
      OutRows{dk, n * c, c, hd}, OutRows{dv, n * c, c, hd}, dbias, scratch, b_,
      n, nh, hd, nw, 0, 0, 0, scale, (cudaStream_t)stream);
}

}  // extern "C"
