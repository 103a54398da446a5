// Packed window attention forward for Video Swin, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of vitta_tpu/ops/pallas_attention.py:
//   _packed_fwd_kernel (:448) with its head loop _heads_fwd (:403),
//   launched by _packed_attn_fwd (:556).
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

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;               // query rows per warp pass
constexpr int kTMax = 13;              // keys per lane
constexpr int kNMax = kTMax * 32;      // 416
constexpr int kKStride = kNMax + 1;    // odd: the transposing store is conflict-free

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// bias[h, i, j] from the dense (nh, N, N) form, or from the Toeplitz slices
// (nh, 2wd-1, hw, hw): block-row d1 = i / hw, block-column d2 = j / hw.
__device__ __forceinline__ float bias_at(const float* __restrict__ bias,
                                         int compact, int h, int i, int j,
                                         int n, int wd, int hw) {
  if (!compact) return bias[((size_t)h * n + i) * n + j];
  const int d1 = i / hw, ii = i - d1 * hw;
  const int d2 = j / hw, jj = j - d2 * hw;
  return bias[(((size_t)h * (2 * wd - 1) + d1 - d2 + wd - 1) * hw + ii) * hw + jj];
}

__global__ void __launch_bounds__(kThreads, 1)
packed_attn_fwd_kernel(const float* __restrict__ qkv,
                       const float* __restrict__ bias,
                       const float* __restrict__ mask,
                       float* __restrict__ out, float* __restrict__ ms,
                       int n, int nh, int hd, int nw, int compact, int wd,
                       int hw, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int c = nh * hd, c3 = 3 * c;
  const int n4 = round4(n);
  float* Kt = smem;                               // (hd, kKStride)
  float* Vs = Kt + round4(hd * kKStride);         // (n4, hd)
  float* Ps = Vs + round4(n4 * hd);               // (kWarps, kRows, kNMax)
  float* Qs = Ps + kWarps * kRows * kNMax;        // (kWarps, kRows, 32)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* base = qkv + (size_t)b * n * c3 + h * hd;

  for (int idx = tid; idx < n * hd; idx += kThreads) {
    const int j = idx / hd, d = idx - j * hd;
    const float* row = base + (size_t)j * c3;
    Kt[d * kKStride + j] = row[c + d];
    Vs[j * hd + d] = row[2 * c + d];
  }
  const int kpad = kKStride - n;
  for (int idx = tid; idx < hd * kpad; idx += kThreads) {
    const int d = idx / kpad;
    Kt[d * kKStride + n + (idx - d * kpad)] = 0.f;
  }
  for (int idx = tid; idx < (n4 - n) * hd; idx += kThreads)
    Vs[n * hd + idx] = 0.f;
  __syncthreads();

  float* Pw = Ps + warp * kRows * kNMax;
  float* Qw = Qs + warp * kRows * 32;
  const float* mask_b =
      mask != nullptr ? mask + (size_t)(b % nw) * n * n : nullptr;

  // blockIdx.z shares the problem's query rows among gridDim.z blocks
  for (int i0 = (blockIdx.z * kWarps + warp) * kRows; i0 < n;
       i0 += gridDim.z * kWarps * kRows) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      Qw[r * 32 + lane] =
          (i < n && lane < hd) ? base[(size_t)i * c3 + lane] : 0.f;
    }
    __syncwarp();

    float acc[kRows][kTMax];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < kTMax; ++t) acc[r][t] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float kv[kTMax];
      const float* kd = Kt + d * kKStride + lane;
#pragma unroll
      for (int t = 0; t < kTMax; ++t) kv[t] = kd[32 * t];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float q = Qw[r * 32 + d];
#pragma unroll
        for (int t = 0; t < kTMax; ++t) acc[r][t] = fmaf(q, kv[t], acc[r][t]);
      }
    }

    float rsum[kRows], rmax[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;          // the same for every lane of the warp
      float* pr = Pw + r * kNMax + lane;
      if (i < n) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < kTMax; ++t) {
          const int j = lane + 32 * t;
          float l = -CUDART_INF_F;
          if (j < n) {
            l = acc[r][t] * scale + bias_at(bias, compact, h, i, j, n, wd, hw);
            if (mask_b != nullptr) l += mask_b[(size_t)i * n + j];
          }
          acc[r][t] = l;
          mx = fmaxf(mx, l);
        }
        mx = warp_max(mx);
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < kTMax; ++t) {
          const float e =
              (lane + 32 * t < n) ? __expf(acc[r][t] - mx) : 0.f;
          pr[32 * t] = e;
          s += e;
        }
        rsum[r] = warp_sum(s);
        rmax[r] = mx;
      } else {
#pragma unroll
        for (int t = 0; t < kTMax; ++t) pr[32 * t] = 0.f;
        rsum[r] = 1.f;
        rmax[r] = 0.f;
      }
    }
    __syncwarp();

    if (lane < hd) {
      float o[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) o[r] = 0.f;
      for (int j = 0; j < n4; j += 4) {
        const float v0 = Vs[j * hd + lane];
        const float v1 = Vs[(j + 1) * hd + lane];
        const float v2 = Vs[(j + 2) * hd + lane];
        const float v3 = Vs[(j + 3) * hd + lane];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 p =
              *reinterpret_cast<const float4*>(Pw + r * kNMax + j);
          o[r] = fmaf(p.x, v0, o[r]);
          o[r] = fmaf(p.y, v1, o[r]);
          o[r] = fmaf(p.z, v2, o[r]);
          o[r] = fmaf(p.w, v3, o[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i < n)
          out[((size_t)b * n + i) * c + h * hd + lane] = o[r] / rsum[r];
      }
    }
    if (ms != nullptr && lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i < n) {
          float* m = ms + ((size_t)b * n + i) * 2 * nh + 2 * h;
          m[0] = rmax[r];
          m[1] = rsum[r];
        }
      }
    }
    __syncwarp();     // the strips are rewritten by the next pass
  }
}

int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || count <= 0)
    count = 132;
  return count;
}

size_t smem_bytes(int n, int hd) {
  const size_t floats = (size_t)round4(hd * kKStride) +
                        round4(round4(n) * hd) + kWarps * kRows * kNMax +
                        kWarps * kRows * 32;
  return floats * sizeof(float);
}

}  // namespace

extern "C" {

// The largest window and head size the kernel takes.
int vitta_attn_max_tokens() { return kNMax; }
int vitta_attn_max_head_dim() { return 32; }

// bias: dense (nh, n, n) when compact == 0, else (nh, 2wd-1, hw, hw) with
// wd*hw == n.  mask: (nw, n, n) or null.  ms: (b_, n, 2nh) or null.
int vitta_attn_packed_fwd(const float* qkv, const float* bias,
                          const float* mask, float* out, float* ms, int b_,
                          int n, int nh, int hd, int nw, int compact, int wd,
                          int hw, float scale, void* stream) {
  if (b_ <= 0 || n <= 0 || nh <= 0 || hd <= 0 || n > kNMax || hd > 32 ||
      b_ > 65535 || (mask != nullptr && nw <= 0) ||
      (compact && (wd <= 0 || hw <= 0 || wd * hw != n)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        packed_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // few problems (the late stages at one or two clips): split each one's
  // query rows over up to 4 blocks, as many as still fit the card at once
  int split = sm_count() / (nh * b_);
  split = split < 1 ? 1 : (split > 4 ? 4 : split);
  const dim3 grid(nh, b_, split);
  packed_attn_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      qkv, bias, mask, out, ms, n, nh, hd, nw, compact, wd, hw, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
