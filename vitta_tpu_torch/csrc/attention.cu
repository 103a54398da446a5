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
// What bounds it: operations, five (N, N, hd) products per problem (10 N^2 hd
// of 12 N^2 hd + 10 N^2 float32 operations) against 11 N hd floats of q, k,
// v, g, dq, dk, dv.  The TPU kernel holds a window's (N, N) logits per head
// in VMEM and adds dbias into a block that its sequential grid revisits.
// Here one block owns one (window, head) problem in one pass:
//  * K and V of the problem lie in shared memory (2 x 416 x 36 floats); a
//    warp owns 32 keys (13 warps cover N <= 416), the block walks the query
//    rows 16 at a time, and the q and g strips (with the rows' m and s) come
//    in by cp.async, double-buffered, while the previous strip computes.
//    So do the strip's 16 rows of the bias and the mask (the compact bias
//    gathered run by run), issued once the logits of the strip before have
//    read theirs, so that their device-memory latency hides behind the rest
//    of the strip.  210 KB a block, one block an SM, and ptxas allots 128
//    registers a thread (13 warps count as 16);
//  * per strip and warp: s^T = K q^T and dp^T = V g^T as (16 keys, 8 rows)
//    tiles; p, the warp's part of rs, then rs from all warps through shared
//    memory in warp order; dl; dv += p^T g and dk += dl^T q, accumulated in
//    registers (64 a lane) over the strips; and the warp's share of dq = dl K
//    over its keys, the shares added in warp order through shared memory.
//    Five products, none recomputed; nothing of size (N, N) leaves the chip
//    but dl, and dl only when dbias is wanted;
//  * every product runs on the tensor cores, mma.sync.m16n8k8 on tf32
//    operands, at float32 accuracy: each operand is split x = hi + lo into
//    two tf32 values (hi rounded to nearest, lo the remainder cut to tf32,
//    four integer and float operations) and a b = lo*hi + hi*lo + hi*hi
//    ("3xTF32").  One tf32 product keeps about three decimal digits, which
//    the 2e-5 tolerance of the backward does not allow.  mma.sync and not
//    wgmma: wgmma reads tf32 operands only K-major from shared memory, and
//    dv = p^T g and dk = dl^T q contract over query rows, which would need
//    transposed copies.  Computing s^T rather than s makes the accumulator
//    tiles of s^T and dp^T the A operands of those two products as they lie
//    in registers (a k step maps column t to row 2t and t + 4 to 2t + 1); only
//    dl crosses the lanes, through the warp's own shared-memory tile, for dq;
//  * the logits read the bias and mask from shared memory in the tiles'
//    order, four rows of eight neighbouring keys an access, without a
//    branch: what lies past row or key N is computed and then not selected;
//  * dl (B_, nh, N, N) goes to device memory, four rows of eight keys per
//    access, and a second kernel adds the windows in their order (and, for
//    the compact form, the block diagonal);
//  * where whole problems would leave SMs without a block (Swin-B's last
//    stage: 64 problems for 2 clips, 32 for one), up to four blocks share a
//    problem by strips, write their shares of dk and dv to scratch, and a
//    third kernel adds them in block order.
// No float atomics anywhere: every output is the same from run to run.  The
// logits are recomputed in another order than the forward summed them, so
// p is not the forward's to the last bit and its rows sum to 1 within the
// float32 rounding of the products.  The mask has no gradient.
//
// Per (head, window).  The TPU kernel of this route takes q, k and v as three
// head-major tensors (nh, B_, N, hd), which costs a transposing copy of each
// in front and of the output behind, one grid step per (head, window), a
// dense bias only, and keeps no row maximum and sum: its backward rebuilds
// the softmax from q and k.  Here the device code above addresses q, k, v
// and their cotangents through a base pointer and three strides each
// (attention_kernels.cuh: Rows), so the same kernels read the three where
// they lie: as views of the packed projection output, as (B_, N, nh, hd)
// tensors of their own, or head-major; no transposing copy exists.  The
// forward writes the row maximum and sum as the packed one does, and the
// backward reads them: the same launches as the packed backward.  dq, dk, dv
// are three outputs, each (B_, N, nh, hd); dbias is dense.
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

// Floats of scratch vitta_attn_packed_bwd and vitta_attn_heads_bwd need:
// dl (b_, nh, n, n) and, where a problem is shared by several blocks, their
// shares of dk and dv.
long long vitta_attn_bwd_scratch_floats(int b_, int n, int nh, int hd) {
  return vitta::attn::bwd_scratch_floats(b_, n, nh, hd);
}

// Blocks that share one problem in the backward (1 where there are enough
// problems for the card's SMs).
int vitta_attn_bwd_split(int b_, int nh) {
  return vitta::attn::bwd_split(b_, nh);
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
// (nh, n, n).  mask: (nw, n, n) or null.  out: (b_, n, nh, hd).  ms:
// (b_, n, 2nh) or null.
int vitta_attn_heads_fwd(const float* q, const float* k, const float* v,
                         const long long* strides, const float* bias,
                         const float* mask, float* out, float* ms, int b_,
                         int n, int nh, int hd, int nw, float scale,
                         void* stream) {
  using vitta::attn::InRows;
  const long long* s = strides;
  return (int)vitta::attn::launch_fwd(
      InRows{q, s[0], s[1], s[2]}, InRows{k, s[3], s[4], s[5]},
      InRows{v, s[6], s[7], s[8]}, bias, mask, out, ms, b_, n, nh, hd, nw, 0,
      0, 0, scale, (cudaStream_t)stream);
}

// ms as the forward wrote it; g: (b_, n, nh, hd), the cotangent of out; dq,
// dk, dv: (b_, n, nh, hd), contiguous; dbias: (nh, n, n).
int vitta_attn_heads_bwd(const float* q, const float* k, const float* v,
                         const long long* strides, const float* bias,
                         const float* mask, const float* ms, const float* g,
                         float* dq, float* dk, float* dv, float* dbias,
                         float* scratch, int b_, int n, int nh, int hd,
                         int nw, float scale, void* stream) {
  using vitta::attn::InRows;
  using vitta::attn::OutRows;
  if (dbias == nullptr) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const long long c = (long long)nh * hd;
  return (int)vitta::attn::launch_bwd(
      InRows{q, s[0], s[1], s[2]}, InRows{k, s[3], s[4], s[5]},
      InRows{v, s[6], s[7], s[8]}, bias, mask, ms, g,
      OutRows{dq, n * c, c, hd}, OutRows{dk, n * c, c, hd},
      OutRows{dv, n * c, c, hd}, dbias, scratch, b_, n, nh, hd, nw, 0, 0, 0,
      scale, (cudaStream_t)stream);
}

}  // extern "C"
