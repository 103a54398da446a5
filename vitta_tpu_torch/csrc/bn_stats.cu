// BatchNorm (inference form) + optional ReLU + channel statistics of the
// output, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of vitta_tpu/ops/pallas_stats.py:
//   _kernel (:41, launched by fused_bn_relu_stats :68).
// The TPU function has no backward (nothing differentiates it there); the
// port's BatchNorm calls this op on the adaptation path, so the backward is
// written here.
//
// What it computes, for x (R, C) with channels last and per-channel
// scale, bias, mean, var (C), all float32, or x, y, g_y and dx bfloat16:
//   y = (x - mean) * rsqrt(var + eps) * scale + bias,  y = max(y, 0) if relu
//   m = sum_rows(y) / R,  v = sum_rows(y^2) / R - m^2          (both (C))
// and, from the cotangents g_y (R, C), g_m (C), g_v (C), each of which may
// be absent (a null pointer: zero), with inv = rsqrt(var + eps) * scale and
// xhat = (x - mean) * rsqrt(var + eps):
//   G = g_y + g_m / R + g_v * 2 (y - m) / R,   G = 0 where relu cut y
//   dx = G * inv,  dscale = sum_rows(G * xhat),  dbias = sum_rows(G)
// y is recomputed from x in the backward; mean and var get no gradient.
//
// At bfloat16 the arithmetic is float32 and y is rounded to bfloat16 where
// it is stored; m and v are the statistics of that rounded y, as
// vitta_tpu/models/layers.py:183-190 (the BatchNorm this op serves there)
// taps them from y.astype(float32), and the backward's y in the g_v term
// is the rounded one too.  G stays float32; dx is rounded to bfloat16 once.
// (The Pallas kernel, which no vitta_tpu model calls, sums the unrounded y:
// pallas_stats.py:54-57.)
//
// What bounds it: bytes.  A dozen operations per element against one read of
// x and one write of y (backward: x and g_y read, dx written).  The design:
// threads run along C, so a warp reads neighbouring addresses of one row, 16
// bytes a thread where C is a multiple of 4 (of 8 at bfloat16; one element a
// thread where not, or where a view starts off a 16-byte boundary); a block
// owns a chunk of rows and
// a tile of columns, keeps each column's sums in registers while it writes y
// (or dx), and writes one partial per (chunk, column).  The TPU kernel adds
// into one scratch block that its sequential grid revisits; a CUDA grid has
// no order, so a second launch adds the partials in a fixed order
// (reduce.cuh) and no float atomic is used: two runs are bit-equal.  The TPU
// kernel's row tile (a divisor of R, a multiple of 8) has no counterpart: any
// R and any C >= 1 are taken.

#include <cuda_bf16.h>

#include <cstdint>

#include "reduce.cuh"

namespace vitta {

constexpr int kBnLanes = 32;      // threads along C
constexpr int kBnWarps = 8;       // rows in flight per block
constexpr int kBnChunk = 128;     // rows per block

inline long long bn_chunks(long long rows) {
  return (rows + kBnChunk - 1) / kBnChunk;
}

using bf16 = __nv_bfloat16;

// V values of type E from p as float32 (16 bytes where V > 1), and back,
// rounded to nearest even at bfloat16.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    out[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&in)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    *p = in[0];
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const bf16* p, float (&out)[V]) {
  if constexpr (V == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[2 * j] = __uint_as_float(w[j] << 16);
      out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    out[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(bf16* p, const float (&in)[V]) {
  if constexpr (V == 8) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(in[2 * j], in[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *p = __float2bfloat16_rn(in[0]);
  }
}

// v rounded to E, as float32: the value store_vec writes (the identity at
// float32).
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Adds the block's kBnWarps per-row-group sums of V columns in the order of
// the groups and writes them to out[0..V) (warp 0 only).
template <int V>
__device__ __forceinline__ void block_col_sum(
    float (*part)[kBnLanes * V + 1], const float (&s)[V], float* out,
    bool active) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int j = 0; j < V; ++j) part[ty][tx * V + j] = s[j];
  __syncthreads();
  if (ty == 0 && active) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kBnWarps; ++w) t += part[w][tx * V + j];
      out[j] = t;
    }
  }
  __syncthreads();
}

// grid (chunks, column tiles), block (32, 8).  partial (chunks, 2, c): the
// chunk's sum of y, then of y^2.
template <int V, bool RELU, class E>
__global__ void __launch_bounds__(kBnLanes * kBnWarps)
bn_stats_fwd_kernel(const E* __restrict__ x,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ mean,
                    const float* __restrict__ var, E* __restrict__ y,
                    float* __restrict__ partial, long long rows, int c,
                    float eps) {
  __shared__ float part[kBnWarps][kBnLanes * V + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = (blockIdx.y * kBnLanes + tx) * V;
  const bool active = col < c;      // c is a multiple of V
  const long long r0 = (long long)blockIdx.x * kBnChunk;
  const long long r1 = r0 + kBnChunk < rows ? r0 + kBnChunk : rows;
  float inv[V], shift[V], s[V], ss[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s[j] = 0.f;
    ss[j] = 0.f;
    if (active) {
      inv[j] = rsqrtf(var[col + j] + eps) * scale[col + j];
      shift[j] = bias[col + j] - mean[col + j] * inv[j];
    }
  }
  if (active) {
    for (long long r = r0 + ty; r < r1; r += kBnWarps) {
      float v[V];
      load_vec<V>(x + r * c + col, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float t = fmaf(v[j], inv[j], shift[j]);
        if (RELU) t = fmaxf(t, 0.f);
        t = round_to(t, y);          // the statistics are of the stored y
        v[j] = t;
        s[j] += t;
        ss[j] = fmaf(t, t, ss[j]);
      }
      store_vec<V>(y + r * c + col, v);
    }
  }
  float* out = partial + (long long)blockIdx.x * 2 * c + col;
  block_col_sum<V>(part, s, out, active);
  block_col_sum<V>(part, ss, out + c, active);
}

// stats (2, c): m, then v = E[y^2] - m^2, from the chunks' partials added
// in the order of the chunks (nvcc does not reassociate float32 sums unless
// asked to, and the build does not ask).
__global__ void __launch_bounds__(kReduceThreads)
bn_stats_finish_kernel(const float* __restrict__ partial,
                       float* __restrict__ stats, long long chunks, int c,
                       float inv_rows) {
  const int col = blockIdx.x * kReduceThreads + threadIdx.x;
  if (col >= c) return;
  // compensated (Kahan) sums: E[y^2] - m^2 cancels where |m| is far above
  // the spread, and a plain running sum over hundreds of chunks would add
  // several float32 roundings of m^2 to v
  float s = 0.f, ss = 0.f, cs = 0.f, css = 0.f;
  for (long long p = 0; p < chunks; ++p) {
    const float a = partial[p * 2 * c + col] - cs;
    const float ts = s + a;
    cs = (ts - s) - a;
    s = ts;
    const float b = partial[p * 2 * c + c + col] - css;
    const float tss = ss + b;
    css = (tss - ss) - b;
    ss = tss;
  }
  const float m = s * inv_rows;
  stats[col] = m;
  stats[c + col] = ss * inv_rows - m * m;
}

// grid (chunks, column tiles), block (32, 8).  partial (chunks, 2, c): the
// chunk's sum of G * xhat, then of G.  g_y, g_m, g_v may be null.
template <int V, bool RELU, class E>
__global__ void __launch_bounds__(kBnLanes * kBnWarps)
bn_stats_bwd_kernel(const E* __restrict__ x,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ mean,
                    const float* __restrict__ var,
                    const float* __restrict__ m,
                    const E* __restrict__ g_y,
                    const float* __restrict__ g_m,
                    const float* __restrict__ g_v, E* __restrict__ dx,
                    float* __restrict__ partial, long long rows, int c,
                    float eps) {
  __shared__ float part[kBnWarps][kBnLanes * V + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = (blockIdx.y * kBnLanes + tx) * V;
  const bool active = col < c;
  const long long r0 = (long long)blockIdx.x * kBnChunk;
  const long long r1 = r0 + kBnChunk < rows ? r0 + kBnChunk : rows;
  const float inv_rows = 1.f / (float)rows;
  float rstd[V], inv[V], shift[V], mu[V], mstat[V], gm[V], gv2[V];
  float ds[V], db[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ds[j] = 0.f;
    db[j] = 0.f;
    if (active) {
      rstd[j] = rsqrtf(var[col + j] + eps);
      inv[j] = rstd[j] * scale[col + j];
      mu[j] = mean[col + j];
      shift[j] = bias[col + j] - mu[j] * inv[j];
      mstat[j] = m[col + j];
      gm[j] = g_m ? g_m[col + j] * inv_rows : 0.f;
      gv2[j] = g_v ? 2.f * g_v[col + j] * inv_rows : 0.f;
    }
  }
  if (active) {
    for (long long r = r0 + ty; r < r1; r += kBnWarps) {
      float v[V], g[V];
      load_vec<V>(x + r * c + col, v);
      if (g_y) {
        load_vec<V>(g_y + r * c + col, g);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) g[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = fmaf(v[j], inv[j], shift[j]);
        const float yv = round_to(RELU ? fmaxf(t, 0.f) : t, x);
        float G = g[j] + gm[j] + gv2[j] * (yv - mstat[j]);
        if (RELU && !(t > 0.f)) G = 0.f;
        ds[j] = fmaf(G, (v[j] - mu[j]) * rstd[j], ds[j]);
        db[j] += G;
        g[j] = G * inv[j];
      }
      store_vec<V>(dx + r * c + col, g);
    }
  }
  float* out = partial + (long long)blockIdx.x * 2 * c + col;
  block_col_sum<V>(part, ds, out, active);
  block_col_sum<V>(part, db, out + c, active);
}

template <int V>
inline dim3 bn_grid(long long rows, int c) {
  const int per_block = kBnLanes * V;
  return dim3((unsigned)bn_chunks(rows), (unsigned)((c + per_block - 1) / per_block));
}

// 16-byte loads need c a multiple of W (4 floats, 8 bfloat16 values) and
// every (rows, c) pointer aligned.
inline bool bn_vectorized(int c, int w, const void* a, const void* b,
                          const void* d) {
  const unsigned long long bits = (unsigned long long)a |
                                  (unsigned long long)b |
                                  (unsigned long long)d;
  return c % w == 0 && (bits & 15ULL) == 0;
}

inline bool bn_shape_ok(long long rows, int c) {
  // grid.x holds the chunks (at most 2^31 - 1), grid.y the column tiles
  return rows > 0 && c > 0 && bn_chunks(rows) <= 2147483647LL &&
         (c + kBnLanes - 1) / kBnLanes <= 65535;
}

// Values a 16-byte unit of E holds.
template <class E> constexpr int kVec = 16 / (int)sizeof(E);

// "base<v, relu>" at float32, "base<v, relu, __nv_bfloat16>" at bfloat16:
// the kernel's name in the library's launch counts.
inline std::string kernel_name(const char* base, int v, bool relu,
                               const float*) {
  return template_name(base, v, relu);
}
inline std::string kernel_name(const char* base, int v, bool relu,
                               const bf16*) {
  std::string s = template_name(base, v, relu);
  return s.insert(s.size() - 1, ", __nv_bfloat16");
}

// The forward: the pass over x, then the ordered sum of its partials.
template <class E>
int bn_fwd(const E* x, const float* scale, const float* bias,
           const float* mean, const float* var, E* y, float* stats,
           float* scratch, long long rows, int c, float eps, int relu,
           cudaStream_t st) {
  if (!bn_shape_ok(rows, c)) return (int)cudaErrorInvalidValue;
  constexpr int W = kVec<E>;
  const dim3 block(kBnLanes, kBnWarps);
  const bool vec = bn_vectorized(c, W, x, y, nullptr);
  if (vec) {
    const dim3 grid = bn_grid<W>(rows, c);
    if (relu)
      bn_stats_fwd_kernel<W, true, E><<<grid, block, 0, st>>>(
          x, scale, bias, mean, var, y, scratch, rows, c, eps);
    else
      bn_stats_fwd_kernel<W, false, E><<<grid, block, 0, st>>>(
          x, scale, bias, mean, var, y, scratch, rows, c, eps);
  } else {
    const dim3 grid = bn_grid<1>(rows, c);
    if (relu)
      bn_stats_fwd_kernel<1, true, E><<<grid, block, 0, st>>>(
          x, scale, bias, mean, var, y, scratch, rows, c, eps);
    else
      bn_stats_fwd_kernel<1, false, E><<<grid, block, 0, st>>>(
          x, scale, bias, mean, var, y, scratch, rows, c, eps);
  }
  count_launch(
      kernel_name("bn_stats_fwd_kernel", vec ? W : 1, relu != 0, x).c_str());
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_stats_finish_kernel<<<(c + kReduceThreads - 1) / kReduceThreads,
                           kReduceThreads, 0, st>>>(
      scratch, stats, bn_chunks(rows), c, 1.f / (float)rows);
  count_launch("bn_stats_finish_kernel");
  return (int)cudaGetLastError();
}

// The backward: the pass over x and g_y, then one ordered sum of the
// partials, which are (chunks, 2 c), for dscale and dbias.
template <class E>
int bn_bwd(const E* x, const float* scale, const float* bias,
           const float* mean, const float* var, const float* m, const E* g_y,
           const float* g_m, const float* g_v, E* dx, float* dsb,
           float* scratch, long long rows, int c, float eps, int relu,
           cudaStream_t st) {
  if (!bn_shape_ok(rows, c)) return (int)cudaErrorInvalidValue;
  constexpr int W = kVec<E>;
  const dim3 block(kBnLanes, kBnWarps);
  const bool vec = bn_vectorized(c, W, x, g_y, dx);
  if (vec) {
    const dim3 grid = bn_grid<W>(rows, c);
    if (relu)
      bn_stats_bwd_kernel<W, true, E><<<grid, block, 0, st>>>(
          x, scale, bias, mean, var, m, g_y, g_m, g_v, dx, scratch, rows, c,
          eps);
    else
      bn_stats_bwd_kernel<W, false, E><<<grid, block, 0, st>>>(
          x, scale, bias, mean, var, m, g_y, g_m, g_v, dx, scratch, rows, c,
          eps);
  } else {
    const dim3 grid = bn_grid<1>(rows, c);
    if (relu)
      bn_stats_bwd_kernel<1, true, E><<<grid, block, 0, st>>>(
          x, scale, bias, mean, var, m, g_y, g_m, g_v, dx, scratch, rows, c,
          eps);
    else
      bn_stats_bwd_kernel<1, false, E><<<grid, block, 0, st>>>(
          x, scale, bias, mean, var, m, g_y, g_m, g_v, dx, scratch, rows, c,
          eps);
  }
  count_launch(
      kernel_name("bn_stats_bwd_kernel", vec ? W : 1, relu != 0, x).c_str());
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reduce_partials(scratch, dsb, (int)bn_chunks(rows),
                                     2LL * c, st);
}

}  // namespace vitta

extern "C" {

// Floats of scratch either call needs: the partials, (chunks, 2, c).
long long vitta_bn_stats_scratch_floats(long long rows, int c) {
  return vitta::bn_chunks(rows) * 2 * (long long)c;
}

// y (rows, c); stats (2, c) = m then v.  Two launches.
int vitta_bn_stats_fwd(const float* x, const float* scale, const float* bias,
                       const float* mean, const float* var, float* y,
                       float* stats, float* scratch, long long rows, int c,
                       float eps, int relu, void* stream) {
  return vitta::bn_fwd(x, scale, bias, mean, var, y, stats, scratch, rows, c,
                       eps, relu, (cudaStream_t)stream);
}

// dx (rows, c); dsb (2, c) = dscale then dbias.  g_y, g_m, g_v may be null.
// Two launches.
int vitta_bn_stats_bwd(const float* x, const float* scale, const float* bias,
                       const float* mean, const float* var, const float* m,
                       const float* g_y, const float* g_m, const float* g_v,
                       float* dx, float* dsb, float* scratch, long long rows,
                       int c, float eps, int relu, void* stream) {
  return vitta::bn_bwd(x, scale, bias, mean, var, m, g_y, g_m, g_v, dx, dsb,
                       scratch, rows, c, eps, relu, (cudaStream_t)stream);
}

// The same at bfloat16: x, y, g_y and dx bfloat16, everything else float32.
int vitta_bn_stats_fwd_bf16(const void* x, const float* scale,
                            const float* bias, const float* mean,
                            const float* var, void* y, float* stats,
                            float* scratch, long long rows, int c, float eps,
                            int relu, void* stream) {
  return vitta::bn_fwd(reinterpret_cast<const vitta::bf16*>(x), scale, bias,
                       mean, var, reinterpret_cast<vitta::bf16*>(y), stats,
                       scratch, rows, c, eps, relu, (cudaStream_t)stream);
}

int vitta_bn_stats_bwd_bf16(const void* x, const float* scale,
                            const float* bias, const float* mean,
                            const float* var, const float* m, const void* g_y,
                            const float* g_m, const float* g_v, void* dx,
                            float* dsb, float* scratch, long long rows, int c,
                            float eps, int relu, void* stream) {
  return vitta::bn_bwd(reinterpret_cast<const vitta::bf16*>(x), scale, bias,
                       mean, var, m, reinterpret_cast<const vitta::bf16*>(g_y),
                       g_m, g_v, reinterpret_cast<vitta::bf16*>(dx), dsb,
                       scratch, rows, c, eps, relu, (cudaStream_t)stream);
}

}  // extern "C"
