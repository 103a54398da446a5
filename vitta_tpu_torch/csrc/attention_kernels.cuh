// The device code and the host-side launchers of the packed window attention,
// forward and backward, shared by attention.cu (the packed op) and
// attention_proj.cu (the projection-fused ops, which run the same kernels
// between their own matrix products).  attention.cu's header says what the
// kernels compute, what bounds them and how the work is laid out.

#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>

namespace vitta {
namespace attn {

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


// ------------------------------------------------------------------ backward

// Rows per warp pass and warps per block.  The block's two (hd, 417) tiles
// leave one block to an SM, so the warps are all that hides its latencies,
// and p and dl together are 26 registers per row and lane.  2 x 16 was the
// fastest of five shapes at every Swin-B stage on an H100
// (vitta_tpu_torch/tools/backward_variants.py builds this source with other
// values of the two macros and times them; PERF.md has the numbers).
#ifndef VITTA_ATTN_BWD_ROWS
#define VITTA_ATTN_BWD_ROWS 2
#endif
#ifndef VITTA_ATTN_BWD_WARPS
#define VITTA_ATTN_BWD_WARPS 16
#endif
constexpr int kBwdRows = VITTA_ATTN_BWD_ROWS;    // rows per warp pass
constexpr int kBwdWarps = VITTA_ATTN_BWD_WARPS;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdDChunk = 32 / kBwdRows;        // channels per butterfly
static_assert(kBwdRows * kBwdDChunk == 32, "rows per pass must divide 32");

template <int H>
__device__ __forceinline__ void butterfly_step(float* val, bool up) {
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? val[k] : val[k + H];
    const float keep = up ? val[k + H] : val[k];
    val[k] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Every lane brings val[0..31]; lane L returns the sum over the warp's
// lanes of val[L].  31 shuffles: at each step a lane passes on the half of
// the indices whose bit differs from its own lane's.
__device__ __forceinline__ float warp_transpose_sum(float* val, int lane) {
  butterfly_step<16>(val, (lane & 16) != 0);
  butterfly_step<8>(val, (lane & 8) != 0);
  butterfly_step<4>(val, (lane & 4) != 0);
  butterfly_step<2>(val, (lane & 2) != 0);
  butterfly_step<1>(val, (lane & 1) != 0);
  return val[0];
}

// tile[d][j] = src[j * stride + d] for j < n, d < hd; 0 for n <= j < kKStride.
__device__ __forceinline__ void load_transposed(float* tile,
                                                const float* __restrict__ src,
                                                size_t stride, int n, int hd,
                                                int tid) {
  for (int idx = tid; idx < n * hd; idx += kBwdThreads) {
    const int j = idx / hd, d = idx - j * hd;
    tile[d * kKStride + j] = src[(size_t)j * stride + d];
  }
  const int kpad = kKStride - n;
  for (int idx = tid; idx < hd * kpad; idx += kBwdThreads) {
    const int d = idx / kpad;
    tile[d * kKStride + n + (idx - d * kpad)] = 0.f;
  }
}

// The warp's strip: strip[r][lane] = src[(r0 + r) * stride + lane], 0 outside.
__device__ __forceinline__ void load_strip(float* strip,
                                           const float* __restrict__ src,
                                           size_t stride, int r0, int n,
                                           int hd, int lane) {
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) {
    const int i = r0 + r;
    strip[r * 32 + lane] =
        (i < n && lane < hd) ? src[(size_t)i * stride + lane] : 0.f;
  }
}

// acc[r][t] += sum over d of strip[r][d] * tile[d][lane + 32 t]; d ascending
// and strip * tile in one fmaf, which is the forward's logit bit for bit.
__device__ __forceinline__ void strip_times_tile(
    const float* strip, const float* tile, int hd, int lane,
    float (&acc)[kBwdRows][kTMax]) {
  for (int d = 0; d < hd; ++d) {
    float cv[kTMax];
    const float* td = tile + d * kKStride + lane;
#pragma unroll
    for (int t = 0; t < kTMax; ++t) cv[t] = td[32 * t];
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const float a = strip[r * 32 + d];
#pragma unroll
      for (int t = 0; t < kTMax; ++t) acc[r][t] = fmaf(a, cv[t], acc[r][t]);
    }
  }
}

// Lane r * kBwdDChunk + dd returns the sum over all columns j of
// w[r][j] * tile[d0 + dd][j], the columns being spread over the lanes as
// j = lane + 32 t.
__device__ __forceinline__ float weights_times_tile(
    const float (&w)[kBwdRows][kTMax], const float* tile, int d0, int hd,
    int lane) {
  float part[32];
#pragma unroll
  for (int dd = 0; dd < kBwdDChunk; ++dd) {
    const int d = d0 + dd;
    if (d < hd) {                       // the same for every lane
      float cv[kTMax];
      const float* td = tile + d * kKStride + lane;
#pragma unroll
      for (int t = 0; t < kTMax; ++t) cv[t] = td[32 * t];
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) {
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < kTMax; ++t) sum = fmaf(w[r][t], cv[t], sum);
        part[r * kBwdDChunk + dd] = sum;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) part[r * kBwdDChunk + dd] = 0.f;
    }
  }
  return warp_transpose_sum(part, lane);
}

struct BwdSmem {
  float *t1, *t2, *s1, *s2, *m, *inv, *rs;
};

__device__ __forceinline__ BwdSmem bwd_smem(float* smem, int hd) {
  BwdSmem p;
  p.t1 = smem;                                   // (hd, kKStride)
  p.t2 = p.t1 + round4(hd * kKStride);           // (hd, kKStride)
  p.s1 = p.t2 + round4(hd * kKStride);           // (kBwdWarps, kBwdRows, 32)
  p.s2 = p.s1 + kBwdWarps * kBwdRows * 32;
  p.m = p.s2 + kBwdWarps * kBwdRows * 32;        // (kNMax) each
  p.inv = p.m + kNMax;
  p.rs = p.inv + kNMax;
  return p;
}

// The query kernel: dl and rs to scratch, dq into dqkv.
__global__ void __launch_bounds__(kBwdThreads, 1)
packed_attn_bwd_q_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ bias,
                         const float* __restrict__ mask,
                         const float* __restrict__ ms,
                         const float* __restrict__ g,
                         float* __restrict__ dqkv, float* __restrict__ dl_out,
                         float* __restrict__ rs_out, int n, int nh, int hd,
                         int nw, int compact, int wd, int hw, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int c = nh * hd, c3 = 3 * c;
  const BwdSmem sm = bwd_smem(smem, hd);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* base = qkv + (size_t)b * n * c3 + h * hd;
  const float* gbase = g + (size_t)b * n * c + h * hd;
  float* Kt = sm.t1;
  float* Vt = sm.t2;
  load_transposed(Kt, base + c, c3, n, hd, tid);
  load_transposed(Vt, base + 2 * c, c3, n, hd, tid);
  __syncthreads();

  float* Qw = sm.s1 + warp * kBwdRows * 32;
  float* Gw = sm.s2 + warp * kBwdRows * 32;
  const float* mask_b =
      mask != nullptr ? mask + (size_t)(b % nw) * n * n : nullptr;
  const size_t prob = (size_t)b * nh + h;

  for (int i0 = (blockIdx.z * kBwdWarps + warp) * kBwdRows; i0 < n;
       i0 += gridDim.z * kBwdWarps * kBwdRows) {
    load_strip(Qw, base, c3, i0, n, hd, lane);
    load_strip(Gw, gbase, c, i0, n, hd, lane);
    __syncwarp();

    float p[kBwdRows][kTMax], dl[kBwdRows][kTMax];
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r)
#pragma unroll
      for (int t = 0; t < kTMax; ++t) p[r][t] = 0.f, dl[r][t] = 0.f;
    strip_times_tile(Qw, Kt, hd, lane, p);        // q k^T
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const int i = i0 + r;             // the same for every lane of the warp
      float mx = 0.f, inv = 0.f;
      if (i < n) {
        const float* mr = ms + ((size_t)b * n + i) * 2 * nh + 2 * h;
        mx = mr[0];
        inv = 1.0f / mr[1];
      }
#pragma unroll
      for (int t = 0; t < kTMax; ++t) {
        const int j = lane + 32 * t;
        float e = 0.f;
        if (i < n && j < n) {
          float l = p[r][t] * scale + bias_at(bias, compact, h, i, j, n, wd, hw);
          if (mask_b != nullptr) l += mask_b[(size_t)i * n + j];
          e = __expf(l - mx) * inv;
        }
        p[r][t] = e;
      }
    }
    strip_times_tile(Gw, Vt, hd, lane, dl);       // dp = g v^T
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < kTMax; ++t) part = fmaf(dl[r][t], p[r][t], part);
      const float rs = warp_sum(part);
      const int i = i0 + r;
      float* drow = dl_out + (prob * n + (i < n ? i : 0)) * n;
#pragma unroll
      for (int t = 0; t < kTMax; ++t) {
        const int j = lane + 32 * t;
        dl[r][t] = p[r][t] * (dl[r][t] - rs);
        if (i < n && j < n) drow[j] = dl[r][t];
      }
      if (lane == 0 && i < n) rs_out[prob * n + i] = rs;
    }
    // dq = scale * dl k: lane r * kBwdDChunk + dd ends with row r, channel dd
    const int orow = i0 + lane / kBwdDChunk, od = lane % kBwdDChunk;
    for (int d0 = 0; d0 < hd; d0 += kBwdDChunk) {
      const float tot = weights_times_tile(dl, Kt, d0, hd, lane);
      if (orow < n && d0 + od < hd)
        dqkv[((size_t)b * n + orow) * c3 + h * hd + d0 + od] = tot * scale;
    }
    __syncwarp();     // the strips are rewritten by the next pass
  }
}

// The key kernel: dk and dv into dqkv, from the rs the query kernel left.
__global__ void __launch_bounds__(kBwdThreads, 1)
packed_attn_bwd_kv_kernel(const float* __restrict__ qkv,
                          const float* __restrict__ bias,
                          const float* __restrict__ mask,
                          const float* __restrict__ ms,
                          const float* __restrict__ g,
                          const float* __restrict__ rs_in,
                          float* __restrict__ dqkv, int n, int nh, int hd,
                          int nw, int compact, int wd, int hw, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int c = nh * hd, c3 = 3 * c;
  const BwdSmem sm = bwd_smem(smem, hd);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* base = qkv + (size_t)b * n * c3 + h * hd;
  const float* gbase = g + (size_t)b * n * c + h * hd;
  float* Qt = sm.t1;
  float* Gt = sm.t2;
  load_transposed(Qt, base, c3, n, hd, tid);
  load_transposed(Gt, gbase, c, n, hd, tid);
  const size_t prob = (size_t)b * nh + h;
  for (int i = tid; i < kNMax; i += kBwdThreads) {
    float mx = 0.f, inv = 0.f, rs = 0.f;
    if (i < n) {
      const float* mr = ms + ((size_t)b * n + i) * 2 * nh + 2 * h;
      mx = mr[0];
      inv = 1.0f / mr[1];
      rs = rs_in[prob * n + i];
    }
    sm.m[i] = mx;
    sm.inv[i] = inv;
    sm.rs[i] = rs;
  }
  __syncthreads();

  float* Kw = sm.s1 + warp * kBwdRows * 32;
  float* Vw = sm.s2 + warp * kBwdRows * 32;
  const float* mask_b =
      mask != nullptr ? mask + (size_t)(b % nw) * n * n : nullptr;

  for (int j0 = (blockIdx.z * kBwdWarps + warp) * kBwdRows; j0 < n;
       j0 += gridDim.z * kBwdWarps * kBwdRows) {
    load_strip(Kw, base + c, c3, j0, n, hd, lane);
    load_strip(Vw, base + 2 * c, c3, j0, n, hd, lane);
    __syncwarp();

    // pt[r][t] = p[i][j] and dlt[r][t] = dl[i][j] for key j = j0 + r and
    // query i = lane + 32 t
    float pt[kBwdRows][kTMax], dlt[kBwdRows][kTMax];
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r)
#pragma unroll
      for (int t = 0; t < kTMax; ++t) pt[r][t] = 0.f, dlt[r][t] = 0.f;
    strip_times_tile(Kw, Qt, hd, lane, pt);       // (q k^T)^T
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const int j = j0 + r;
#pragma unroll
      for (int t = 0; t < kTMax; ++t) {
        const int i = lane + 32 * t;
        float e = 0.f;
        if (i < n && j < n) {
          float l = pt[r][t] * scale + bias_at(bias, compact, h, i, j, n, wd, hw);
          if (mask_b != nullptr) l += mask_b[(size_t)i * n + j];
          e = __expf(l - sm.m[i]) * sm.inv[i];
        }
        pt[r][t] = e;
      }
    }
    const int orow = j0 + lane / kBwdDChunk, od = lane % kBwdDChunk;
    float* obase = dqkv + ((size_t)b * n + (orow < n ? orow : 0)) * c3 + h * hd;
    // dv = p^T g
    for (int d0 = 0; d0 < hd; d0 += kBwdDChunk) {
      const float tot = weights_times_tile(pt, Gt, d0, hd, lane);
      if (orow < n && d0 + od < hd) obase[2 * c + d0 + od] = tot;
    }
    strip_times_tile(Vw, Gt, hd, lane, dlt);      // dp^T = (g v^T)^T
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r)
#pragma unroll
      for (int t = 0; t < kTMax; ++t)
        dlt[r][t] = pt[r][t] * (dlt[r][t] - sm.rs[lane + 32 * t]);
    // dk = scale * dl^T q
    for (int d0 = 0; d0 < hd; d0 += kBwdDChunk) {
      const float tot = weights_times_tile(dlt, Qt, d0, hd, lane);
      if (orow < n && d0 + od < hd) obase[c + d0 + od] = tot * scale;
    }
    __syncwarp();     // the strips are rewritten by the next pass
  }
}

// dbias from the dl of all windows, (B_, nh, N, N): the sum over the
// windows in their order; for the compact form also over the block
// diagonal, as collapse_bias_kernel (bias.cu) sums it.
__global__ void __launch_bounds__(256)
dbias_reduce_kernel(const float* __restrict__ dl, float* __restrict__ dbias,
                    int b_, int n, int nh, int compact, int wd, int hw) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  const size_t per_window = (size_t)nh * n * n;
  float acc = 0.f;
  if (!compact) {
    if (idx >= (long long)per_window) return;
    for (int b = 0; b < b_; ++b) acc += dl[b * per_window + idx];
  } else {
    const int a_dim = 2 * wd - 1;
    if (idx >= (long long)nh * a_dim * hw * hw) return;
    const int j = (int)(idx % hw);
    const int i = (int)((idx / hw) % hw);
    const int a = (int)((idx / ((long long)hw * hw)) % a_dim);
    const int h = (int)(idx / ((long long)a_dim * hw * hw));
    for (int d1 = 0; d1 < wd; ++d1) {
      const int d2 = d1 - (a - wd + 1);
      if (d2 < 0 || d2 >= wd) continue;
      const size_t at = ((size_t)h * n + d1 * hw + i) * n + d2 * hw + j;
      for (int b = 0; b < b_; ++b) acc += dl[b * per_window + at];
    }
  }
  dbias[idx] = acc;
}

inline int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || count <= 0)
    count = 132;
  return count;
}

inline size_t smem_bytes(int n, int hd) {
  const size_t floats = (size_t)round4(hd * kKStride) +
                        round4(round4(n) * hd) + kWarps * kRows * kNMax +
                        kWarps * kRows * 32;
  return floats * sizeof(float);
}

inline size_t bwd_smem_bytes(int hd) {
  const size_t floats = 2 * (size_t)round4(hd * kKStride) +
                        2 * kBwdWarps * kBwdRows * 32 + 3 * kNMax;
  return floats * sizeof(float);
}

inline bool bad_dims(int b_, int n, int nh, int hd, int nw, bool with_mask,
              int compact, int wd, int hw) {
  return b_ <= 0 || n <= 0 || nh <= 0 || hd <= 0 || n > kNMax || hd > 32 ||
         b_ > 65535 || (with_mask && nw <= 0) ||
         (compact && (wd <= 0 || hw <= 0 || wd * hw != n));
}

// few problems (the late stages at one or two clips): split each one's rows
// over up to 4 blocks, as many as still fit the card at once
inline int row_split(int problems) {
  const int split = sm_count() / problems;
  return split < 1 ? 1 : (split > 4 ? 4 : split);
}

// The largest window and head size the kernels take.
constexpr int kMaxTokens = kNMax;
constexpr int kMaxHeadDim = 32;

// Forward, one launch on `stream`.  bias: dense (nh, n, n) when compact == 0,
// else (nh, 2wd-1, hw, hw) with wd*hw == n.  mask: (nw, n, n) or null.
// ms: (b_, n, 2nh) or null.  Returns the first error.
inline cudaError_t launch_packed_fwd(const float* qkv, const float* bias,
                                     const float* mask, float* out, float* ms,
                                     int b_, int n, int nh, int hd, int nw,
                                     int compact, int wd, int hw, float scale,
                                     cudaStream_t stream) {
  if (bad_dims(b_, n, nh, hd, nw, mask != nullptr, compact, wd, hw))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        packed_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(nh, b_, row_split(nh * b_));
  packed_attn_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      qkv, bias, mask, out, ms, n, nh, hd, nw, compact, wd, hw, scale);
  return cudaGetLastError();
}

// Floats of scratch launch_packed_bwd needs: dl (b_, nh, n, n) and rs
// (b_, nh, n).
inline long long bwd_scratch_floats(int b_, int n, int nh) {
  return (long long)b_ * nh * n * (n + 1);
}

// Backward, three launches on `stream` (two when dbias is null: the sum of
// dl over the windows is then not taken).  g: (b_, n, nh*hd), the cotangent
// of out; ms as the forward wrote it; dqkv: (b_, n, 3*nh*hd); dbias: in the
// bias's form.  Returns the first error.
inline cudaError_t launch_packed_bwd(const float* qkv, const float* bias,
                                     const float* mask, const float* ms,
                                     const float* g, float* dqkv, float* dbias,
                                     float* scratch, int b_, int n, int nh,
                                     int hd, int nw, int compact, int wd,
                                     int hw, float scale,
                                     cudaStream_t stream) {
  if (bad_dims(b_, n, nh, hd, nw, mask != nullptr, compact, wd, hw))
    return cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        packed_attn_bwd_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(packed_attn_bwd_kv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  float* dl = scratch;
  float* rs = scratch + (size_t)b_ * nh * n * n;
  const dim3 grid(nh, b_, row_split(nh * b_));
  packed_attn_bwd_q_kernel<<<grid, kBwdThreads, smem, stream>>>(
      qkv, bias, mask, ms, g, dqkv, dl, rs, n, nh, hd, nw, compact, wd, hw,
      scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  packed_attn_bwd_kv_kernel<<<grid, kBwdThreads, smem, stream>>>(
      qkv, bias, mask, ms, g, rs, dqkv, n, nh, hd, nw, compact, wd, hw, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || dbias == nullptr) return e;
  const long long outs =
      compact ? (long long)nh * (2 * wd - 1) * hw * hw : (long long)nh * n * n;
  dbias_reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, stream>>>(
      dl, dbias, b_, n, nh, compact, wd, hw);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace vitta
