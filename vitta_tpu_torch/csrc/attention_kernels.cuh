// The device code and the host-side launchers of the window attention,
// forward and backward, shared by attention.cu (the packed op and the
// per-(head, window) op on separate q, k, v) and attention_proj.cu (the
// projection-fused ops, which run the same kernels between their own matrix
// products).  attention.cu's header says what the kernels compute, what
// bounds them and how the work is laid out.

#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace vitta {
namespace attn {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;               // query rows per warp pass
constexpr int kTMax = 13;              // keys per lane
constexpr int kNMax = kTMax * 32;      // 416
constexpr int kKStride = kNMax + 1;    // odd: the transposing store is conflict-free

// The largest window and head size the kernels take, and the largest stride
// between two tokens of q, k or v (a token's offset is taken in 32 bits).
constexpr int kMaxTokens = kNMax;
constexpr int kMaxHeadDim = 32;
constexpr long long kMaxRowStride = 0x7fffffff / kNMax;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// One of q, k, v, or of their cotangents, as the kernels address it: element
// (window b, token i, head h, channel d) lies at p[b*sb + i*sr + h*sh + d].
// The packed projection output (B_, N, 3, nh, hd) gives three of these with
// sb = N*3C, sr = 3C, sh = hd and p moved on by 0, C and 2C; a (B_, N, nh, hd)
// tensor of its own gives sb = N*C, sr = C, sh = hd; a head-major
// (nh, B_, N, hd) one gives sb = N*hd, sr = hd, sh = B_*N*hd.
template <typename T>
struct Rows {
  T* p;
  long long sb, sr, sh;
  __host__ __device__ T* at(int b, int h) const { return p + b * sb + h * sh; }
};
using InRows = Rows<const float>;
using OutRows = Rows<float>;

// q, k or v (which = 0, 1, 2) of the packed tensor (B_, N, 3, nh, hd).
template <typename T>
inline Rows<T> packed_rows(T* qkv, int which, int n, int nh, int hd) {
  const long long c = (long long)nh * hd;
  return Rows<T>{qkv + which * c, n * 3 * c, 3 * c, hd};
}

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

// out, and ms where it is not null.
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_kernel(const InRows q, const InRows k, const InRows v,
                const float* __restrict__ bias,
                const float* __restrict__ mask, float* __restrict__ out,
                float* __restrict__ ms, int n, int nh, int hd, int nw,
                int compact, int wd, int hw, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int c = nh * hd;
  const int n4 = round4(n);
  float* Kt = smem;                               // (hd, kKStride)
  float* Vs = Kt + round4(hd * kKStride);         // (n4, hd)
  float* Ps = Vs + round4(n4 * hd);               // (kWarps, kRows, kNMax)
  float* Qs = Ps + kWarps * kRows * kNMax;        // (kWarps, kRows, 32)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* __restrict__ qb = q.at(b, h);
  const float* __restrict__ kb = k.at(b, h);
  const float* __restrict__ vb = v.at(b, h);
  // row offsets in 32 bits (the launcher checks that they fit): the loop
  // below is address arithmetic and little else
  const int qsr = (int)q.sr, ksr = (int)k.sr, vsr = (int)v.sr;

  for (int idx = tid; idx < n * hd; idx += kThreads) {
    const int j = idx / hd, d = idx - j * hd;
    Kt[d * kKStride + j] = kb[j * ksr + d];
    Vs[j * hd + d] = vb[j * vsr + d];
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
          (i < n && lane < hd) ? qb[i * qsr + lane] : 0.f;
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

// The backward kernel's shape: a warp owns kBwdKeys keys of its problem, the
// block walks the problem's query rows kBwdStrip at a time, and a problem is
// shared by up to kBwdSplit blocks where whole problems would leave SMs
// without one.  vitta_tpu_torch/tools/backward_variants.py builds this source
// with other values of the three macros and times them.
#ifndef VITTA_ATTN_BWD_STRIP
#define VITTA_ATTN_BWD_STRIP 16
#endif
#ifndef VITTA_ATTN_BWD_KEYS
#define VITTA_ATTN_BWD_KEYS 32
#endif
#ifndef VITTA_ATTN_BWD_SPLIT
#define VITTA_ATTN_BWD_SPLIT 4
#endif

constexpr int kBwdStrip = VITTA_ATTN_BWD_STRIP;
constexpr int kBwdKeys = VITTA_ATTN_BWD_KEYS;
constexpr int kBwdSplit = VITTA_ATTN_BWD_SPLIT;
static_assert(kBwdStrip == 16 || kBwdStrip == 32, "strips of 16 or 32 rows");
static_assert(kBwdKeys == 16 || kBwdKeys == 32, "16 or 32 keys per warp");
static_assert(kBwdSplit >= 1, "at least one block per problem");
constexpr int kSN = kBwdStrip / 8;         // 8-row tiles of a strip
constexpr int kSM = kBwdStrip / 16;        // 16-row tiles of a strip
constexpr int kKM = kBwdKeys / 16;         // 16-key tiles of a warp's keys
constexpr int kKK = kBwdKeys / 8;          // 8-key steps over a warp's keys
constexpr int kDT = kMaxHeadDim / 8;       // 8-channel tiles of a head: 4
constexpr int kBwdMaxWarps = kNMax / kBwdKeys;
constexpr int kBwdMaxThreads = kBwdMaxWarps * 32;
// Row stride, in floats, of K, V and the q and g strips in shared memory:
// 36 puts the rows that mma's operand layouts read at once in different banks.
constexpr int kLd = kMaxHeadDim + 4;
constexpr int kTile = kBwdStrip * 32;      // a warp's dl / dq tile

// Warps of a backward block: as many as the keys need.
__host__ __device__ inline int bwd_warps(int n) {
  return (n + kBwdKeys - 1) / kBwdKeys;
}

// Row stride, in floats, of the strip's bias and mask rows in shared memory:
// every key a warp owns, and 4 more than a multiple of 16, so that the four
// rows of eight neighbouring keys an access reads lie in different banks.
__host__ __device__ inline int bwd_ldb(int n) {
  return bwd_warps(n) * kBwdKeys + 4;
}

// x = hi + lo to about 2^-21 of x, hi and lo tf32 values (10 mantissa
// bits): hi rounded to nearest, ties away from zero (what cvt.rna.tf32.f32
// gives, in two integer operations, which issue faster than the
// conversion), x - hi exact in float32, lo that remainder cut to tf32.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// Operands of mma.m16n8k8 with tf32 inputs, each split in two.  A (16 x 8):
// a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// B (8 x 8): b0 (row t, col g), b1 (t + 4, g); the accumulator (16 x 8):
// c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1); g is the
// lane's group (lane / 4) and t its place in it (lane % 4).
struct FragA {
  unsigned hi[4], lo[4];
};
struct FragB {
  unsigned hi[2], lo[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b at float32 accuracy: three tf32 products (lo hi, hi lo, hi hi,
// the small terms first); the lo lo term is below float32's rounding.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// cp.async of kBytes from global to shared memory; without `full` the bytes
// are zeros and nothing is read.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
                 "l"(src), "r"(full ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(s),
                 "l"(src), "n"(kBytes), "r"(full ? kBytes : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Rows r0 .. r0 + rows - 1 of head h of window b of x into dst (rows, kLd),
// asynchronously; rows at or past n and channels at or past hd are zeros.
// vec: 16-byte copies (x's pointer and strides and hd are multiples of 4).
__device__ __forceinline__ void load_rows(float* dst, const InRows& x, int b,
                                          int h, int r0, int rows, int n,
                                          int hd, bool vec, int tid,
                                          int nthreads) {
  const float* base = x.at(b, h);
  if (vec) {
    constexpr int kChunks = kMaxHeadDim / 4;
    for (int idx = tid; idx < rows * kChunks; idx += nthreads) {
      const int r = idx / kChunks, c = (idx - r * kChunks) * 4;
      const bool ok = r0 + r < n && c < hd;
      cp_async<16>(dst + r * kLd + c,
                   ok ? base + (long long)(r0 + r) * x.sr + c : base, ok);
    }
  } else {
    for (int idx = tid; idx < rows * kMaxHeadDim; idx += nthreads) {
      const int r = idx / kMaxHeadDim, c = idx - r * kMaxHeadDim;
      const bool ok = r0 + r < n && c < hd;
      cp_async<4>(dst + r * kLd + c,
                  ok ? base + (long long)(r0 + r) * x.sr + c : base, ok);
    }
  }
}

// A warp's (kBwdStrip, 32) tile holds dl and then the warp's share of dq.
// Row r's columns are permuted by an XOR with a value of r mod 8, so that the
// 32 lanes hit 32 banks when they store either in mma's accumulator layout
// and when they load dl as mma's A operand, two neighbouring columns a lane.
__device__ __forceinline__ int tile_swizzle(int r) {
  const int x = r & 7;
  return ((x & 1) << 3) ^ (((x >> 1) * 20) & 31);
}

__device__ __forceinline__ int tile_at(int r, int c) {
  return r * 32 + (c ^ tile_swizzle(r));
}

// acc (16 keys, 8 rows) tiles += A B^T over the channels for the warp's keys
// kb ..: A (keys, kLd) and B (kBwdStrip rows, kLd) in shared memory.
__device__ __forceinline__ void keys_times_strip(float (&acc)[kKM][kSN][4],
                                                 const float* A,
                                                 const float* B, int kb,
                                                 int gq, int tq) {
#pragma unroll
  for (int ks = 0; ks < kDT; ++ks) {
    FragB bf[kSN];
#pragma unroll
    for (int nt = 0; nt < kSN; ++nt) {
      const int at = (8 * nt + gq) * kLd + 8 * ks + tq;
      bf[nt] = frag_b(B[at], B[at + 4]);
    }
#pragma unroll
    for (int mt = 0; mt < kKM; ++mt) {
      const int at = (kb + 16 * mt + gq) * kLd + 8 * ks + tq;
      const FragA af = frag_a(A[at], A[at + 8 * kLd], A[at + 4],
                              A[at + 8 * kLd + 4]);
#pragma unroll
      for (int nt = 0; nt < kSN; ++nt) mma_3xtf32(acc[mt][nt], af, bf[nt]);
    }
  }
}

// acc (16 keys, 8 channels) tiles += x^T B over the strip's rows, x being
// (16 keys, 8 rows) accumulator tiles as keys_times_strip leaves them: they
// are the A operand once a k step maps column t to row 2t and t + 4 to row
// 2t + 1, and B's rows (kBwdStrip, kLd) in shared memory follow that map.
__device__ __forceinline__ void accumulate_over_strip(
    float (&acc)[kKM][kDT][4], const float (&x)[kKM][kSN][4], const float* B,
    int gq, int tq) {
#pragma unroll
  for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
    for (int mt = 0; mt < kKM; ++mt) {
      const FragA af = frag_a(x[mt][nt][0], x[mt][nt][2], x[mt][nt][1],
                              x[mt][nt][3]);
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        const int at = (8 * nt + 2 * tq) * kLd + 8 * dn + gq;
        mma_3xtf32(acc[mt][dn], af, frag_b(B[at], B[at + kLd]));
      }
    }
}

// One (window, head) problem, or the query strips z, z + Z, ... of it where
// gridDim.z = Z > 1.  p, dl, dq for every strip and the strip's share of dk
// and dv; dl goes to dl_out (b_, nh, n, n) where that is not null.  With
// kv_part null dk and dv are written to their rows, else the block's share
// to kv_part: dk (Z, b_ * nh, n, hd) and then dv in the same form.
__global__ void __launch_bounds__(kBwdMaxThreads, 1)
attn_bwd_kernel(const InRows q, const InRows k, const InRows v,
                const InRows g, const float* __restrict__ bias,
                const float* __restrict__ mask, const float* __restrict__ ms,
                const OutRows dq, const OutRows dk, const OutRows dv,
                float* __restrict__ dl_out, float* __restrict__ kv_part,
                int n, int nh, int hd, int nw, int compact, int wd, int hw,
                float scale, int vec, int vec_rows) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x, warps = nthreads >> 5;
  const int ldb = bwd_ldb(n);
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;     // mma's g and t
  const int keys = warps * kBwdKeys;
  float* Ks = smem;                            // (keys, kLd)
  float* Vs = Ks + keys * kLd;                 // (keys, kLd)
  float* Qs = Vs + keys * kLd;                 // (2, kBwdStrip, kLd)
  float* Gs = Qs + 2 * kBwdStrip * kLd;        // (2, kBwdStrip, kLd)
  float* Ms = Gs + 2 * kBwdStrip * kLd;        // (2, kBwdStrip, 2)
  float* rs_part = Ms + 4 * kBwdStrip;         // (warps, kBwdStrip)
  float* tiles = rs_part + warps * kBwdStrip;  // (warps, kTile)
  float* Bs = tiles + warps * kTile;           // (kBwdStrip, ldb)
  float* Ws = Bs + kBwdStrip * ldb;            // (kBwdStrip, ldb)
  float* tile = tiles + warp * kTile;
  const float* __restrict__ bias_h =
      bias + (size_t)h * (compact ? (2 * wd - 1) * hw * hw : n * n);
  const float* __restrict__ mask_b =
      mask != nullptr ? mask + (size_t)(b % nw) * n * n : nullptr;

  // q and g strip i0 and its rows' maximum and sum into buffer buf
  auto load_strip = [&](int buf, int i0) {
    load_rows(Qs + buf * kBwdStrip * kLd, q, b, h, i0, kBwdStrip, n, hd,
              vec != 0, tid, nthreads);
    load_rows(Gs + buf * kBwdStrip * kLd, g, b, h, i0, kBwdStrip, n, hd,
              vec != 0, tid, nthreads);
    for (int r = tid; r < kBwdStrip; r += nthreads) {
      const bool ok = i0 + r < n;
      cp_async<8>(Ms + (buf * kBwdStrip + r) * 2,
                  ok ? ms + ((size_t)b * n + i0 + r) * 2 * nh + 2 * h : ms,
                  ok);
    }
  };
  // the bias and mask rows of strip i0 into Bs and Ws, a warp a row; the
  // compact bias's row i = d1 hw + ii is wd runs of hw floats, the run of
  // block-column d2 at ((wd-1 + d1 - d2) hw + ii) hw
  auto load_bias = [&](int i0) {
    for (int r = warp; r < kBwdStrip && i0 + r < n; r += warps) {
      const int i = i0 + r;
      float* brow = Bs + r * ldb;
      float* wrow = Ws + r * ldb;
      if (compact) {
        const int d1 = i / hw;
        const float* src = bias_h + ((wd - 1 + d1) * hw + i - d1 * hw) * hw;
        int d2 = lane / hw, jj = lane - d2 * hw;
        for (int j = lane; j < n; j += 32) {
          cp_async<4>(brow + j, src + jj - d2 * hw * hw, true);
          for (jj += 32; jj >= hw; jj -= hw) ++d2;
        }
      } else if (vec_rows) {
        for (int j = 4 * lane; j < n; j += 128)
          cp_async<16>(brow + j, bias_h + i * n + j, true);
      } else {
        for (int j = lane; j < n; j += 32)
          cp_async<4>(brow + j, bias_h + i * n + j, true);
      }
      if (mask_b == nullptr) continue;        // Ws holds zeros
      if (vec_rows) {
        for (int j = 4 * lane; j < n; j += 128)
          cp_async<16>(wrow + j, mask_b + i * n + j, true);
      } else {
        for (int j = lane; j < n; j += 32)
          cp_async<4>(wrow + j, mask_b + i * n + j, true);
      }
    }
  };
  const int strips = (n + kBwdStrip - 1) / kBwdStrip;
  const int z = blockIdx.z, zs = gridDim.z;
  load_rows(Ks, k, b, h, 0, keys, n, hd, vec != 0, tid, nthreads);
  load_rows(Vs, v, b, h, 0, keys, n, hd, vec != 0, tid, nthreads);
  if (mask_b == nullptr)
    for (int idx = tid; idx < kBwdStrip * ldb; idx += nthreads) Ws[idx] = 0.f;
  if (z < strips) {
    load_strip(0, z * kBwdStrip);
    load_bias(z * kBwdStrip);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // the lane's keys: kb + 16 mt + 8 hh + gq
  const int kb = warp * kBwdKeys;
  float* __restrict__ dl_b =
      dl_out != nullptr ? dl_out + ((size_t)b * nh + h) * n * n : nullptr;
  float* __restrict__ dqb = dq.at(b, h);

  // dk and dv of the warp's keys, (16 keys, 8 channels) tiles
  float dka[kKM][kDT][4], dva[kKM][kDT][4];
#pragma unroll
  for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[mt][dn][e] = dva[mt][dn][e] = 0.f;

  int buf = 0;
  for (int s = z; s < strips; s += zs, buf ^= 1) {
    const int i0 = s * kBwdStrip;
    if (s + zs < strips) load_strip(buf ^ 1, (s + zs) * kBwdStrip);
    cp_async_commit();
    const float* Qb = Qs + buf * kBwdStrip * kLd;
    const float* Gb = Gs + buf * kBwdStrip * kLd;
    const float* Mb = Ms + buf * kBwdStrip * 2;

    // s^T = K q^T and dp^T = V g^T on the warp's keys, (16 keys, 8 rows)
    // tiles; the contraction runs over the channels, zeros past hd.  The
    // loops below keep one operand pair in registers at a time: with 13
    // warps a block ptxas allots 128 registers a thread, 64 of them dk and
    // dv
    float st[kKM][kSN][4], dpt[kKM][kSN][4];
#pragma unroll
    for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
      for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[mt][nt][e] = dpt[mt][nt][e] = 0.f;
    keys_times_strip(st, Ks, Qb, kb, gq, tq);
    keys_times_strip(dpt, Vs, Gb, kb, gq, tq);

    // p from the forward's row maximum and sum, and the warp's part of
    // rs = rowsum(dp * p).  Element e of a tile: key + 8 (e >> 1), row
    // 8 nt + 2 tq + (e & 1); the bias and mask from shared memory, where
    // what lies past row or key n is never used
#pragma unroll
    for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 8 * nt + 2 * tq + u;
        const bool rok = i0 + r < n;
        const float rmax = Mb[2 * r];
        const float rinv = rok ? __frcp_rn(Mb[2 * r + 1]) : 0.f;
        float acc = 0.f;
#pragma unroll
        for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int e = 2 * hh + u, j = kb + 16 * mt + 8 * hh + gq;
            const float l =
                st[mt][nt][e] * scale + Bs[r * ldb + j] + Ws[r * ldb + j];
            const float p = rok && j < n ? __expf(l - rmax) * rinv : 0.f;
            st[mt][nt][e] = p;
            acc = fmaf(dpt[mt][nt][e], p, acc);
          }
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        acc += __shfl_xor_sync(0xffffffffu, acc, 8);
        acc += __shfl_xor_sync(0xffffffffu, acc, 16);
        if (gq == 0) rs_part[warp * kBwdStrip + r] = acc;
      }
    __syncthreads();
    // Bs and Ws are read: the next strip's rows come in meanwhile
    if (s + zs < strips) load_bias((s + zs) * kBwdStrip);
    cp_async_commit();

    // rs: the warps' parts in warp order; dl = p (dp - rs)
#pragma unroll
    for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 8 * nt + 2 * tq + u, i = i0 + r;
        float rs = 0.f;
        for (int w = 0; w < warps; ++w) rs += rs_part[w * kBwdStrip + r];
#pragma unroll
        for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int e = 2 * hh + u, j = kb + 16 * mt + 8 * hh + gq;
            const float dl = st[mt][nt][e] * (dpt[mt][nt][e] - rs);
            dpt[mt][nt][e] = dl;
            if (dl_b != nullptr && i < n && j < n) dl_b[i * n + j] = dl;
          }
      }

    // dv += p^T g and dk += dl^T q over the strip's rows
    accumulate_over_strip(dva, st, Gb, gq, tq);
    accumulate_over_strip(dka, dpt, Qb, gq, tq);

    // the warp's share of dq = dl K, over its keys: dl goes through the
    // warp's tile into the A operand's layout (a k step maps column t to key
    // 2t and t + 4 to 2t + 1, and K's rows follow)
#pragma unroll
    for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
      for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tile[tile_at(8 * nt + 2 * tq + (e & 1),
                       16 * mt + 8 * (e >> 1) + gq)] = dpt[mt][nt][e];
    __syncwarp();
    float dqa[kSM][kDT][4];
#pragma unroll
    for (int sm = 0; sm < kSM; ++sm)
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[sm][dn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk) {
#pragma unroll
      for (int sm = 0; sm < kSM; ++sm) {
        const float2 x0 = *reinterpret_cast<const float2*>(
            tile + tile_at(16 * sm + gq, 8 * kk + 2 * tq));
        const float2 x1 = *reinterpret_cast<const float2*>(
            tile + tile_at(16 * sm + gq + 8, 8 * kk + 2 * tq));
        const FragA af = frag_a(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
        for (int dn = 0; dn < kDT; ++dn) {
          const int at = (kb + 8 * kk + 2 * tq) * kLd + 8 * dn + gq;
          mma_3xtf32(dqa[sm][dn], af, frag_b(Ks[at], Ks[at + kLd]));
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int sm = 0; sm < kSM; ++sm)
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        *reinterpret_cast<float2*>(
            tile + tile_at(16 * sm + gq, 8 * dn + 2 * tq)) =
            make_float2(dqa[sm][dn][0], dqa[sm][dn][1]);
        *reinterpret_cast<float2*>(
            tile + tile_at(16 * sm + gq + 8, 8 * dn + 2 * tq)) =
            make_float2(dqa[sm][dn][2], dqa[sm][dn][3]);
      }
    cp_async_wait_all();     // the next strip and its rows have landed
    __syncthreads();

    // the strip's dq: the warps' shares added in warp order
    for (int idx = tid; idx < kTile; idx += nthreads) {
      const int r = idx >> 5, c = (idx & 31) ^ tile_swizzle(r);
      float x = 0.f;
      for (int w = 0; w < warps; ++w) x += tiles[w * kTile + idx];
      if (i0 + r < n && c < hd)
        dqb[(long long)(i0 + r) * dq.sr + c] = x * scale;
    }
  }

  // dk and dv of the warp's keys: accumulator element e of tile (mt, dn) is
  // key kb + 16 mt + gq + 8 (e >> 1), channel 8 dn + 2 tq + (e & 1)
  const long long per = (long long)gridDim.y * nh * n * hd;
  float* dkp = kv_part != nullptr
                   ? kv_part + z * per + ((long long)b * nh + h) * n * hd
                   : nullptr;
#pragma unroll
  for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kb + 16 * mt + gq + 8 * (e >> 1);
        const int d = 8 * dn + 2 * tq + (e & 1);
        if (j >= n || d >= hd) continue;
        if (dkp != nullptr) {
          dkp[j * hd + d] = dka[mt][dn][e];
          dkp[zs * per + j * hd + d] = dva[mt][dn][e];
        } else {
          dk.at(b, h)[(long long)j * dk.sr + d] = dka[mt][dn][e] * scale;
          dv.at(b, h)[(long long)j * dv.sr + d] = dva[mt][dn][e];
        }
      }
}

// dk and dv of problems shared by `parts` blocks: each block's share, as
// attn_bwd_kernel left it in part, added in block order.
__global__ void __launch_bounds__(256)
dkv_sum_kernel(const float* __restrict__ part, const OutRows dk,
               const OutRows dv, int parts, int b_, int n, int nh, int hd,
               float scale) {
  const long long per = (long long)b_ * nh * n * hd;
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= 2 * per) return;
  const bool is_v = idx >= per;
  const long long at = is_v ? idx - per : idx;
  const float* src = part + (is_v ? parts * per : 0) + at;
  float acc = 0.f;
  for (int z = 0; z < parts; ++z) acc += src[z * per];
  const int d = (int)(at % hd);
  const int j = (int)((at / hd) % n);
  const int prob = (int)(at / ((long long)hd * n));
  const int b = prob / nh, h = prob - b * nh;
  if (is_v)
    dv.at(b, h)[(long long)j * dv.sr + d] = acc;
  else
    dk.at(b, h)[(long long)j * dk.sr + d] = acc * scale;
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

inline size_t bwd_smem_bytes(int n) {
  const size_t warps = bwd_warps(n);
  const size_t floats = 2 * warps * kBwdKeys * kLd + 4 * kBwdStrip * kLd +
                        4 * kBwdStrip + warps * kBwdStrip + warps * kTile +
                        2 * kBwdStrip * bwd_ldb(n);
  return floats * sizeof(float);
}

inline bool bad_dims(int b_, int n, int nh, int hd, int nw, bool with_mask,
              int compact, int wd, int hw) {
  return b_ <= 0 || n <= 0 || nh <= 0 || hd <= 0 || n > kNMax || hd > 32 ||
         b_ > 65535 || (with_mask && nw <= 0) ||
         (compact && (wd <= 0 || hw <= 0 || wd * hw != n));
}

// few problems (the late stages at one or two clips): split each one's rows
// over up to `most` blocks, as many as still fit the card at once
inline int row_split(int problems, int most = 4) {
  const int split = sm_count() / problems;
  return split < 1 ? 1 : (split > most ? most : split);
}

// Blocks per problem of the backward.
inline int bwd_split(int b_, int nh) { return row_split(b_ * nh, kBwdSplit); }

// Forward, one launch on `stream`.  bias: dense (nh, n, n) when compact == 0,
// else (nh, 2wd-1, hw, hw) with wd*hw == n.  mask: (nw, n, n) or null.
// out: (b_, n, nh*hd).  ms: (b_, n, 2nh) or null.  Returns the first error.
inline cudaError_t launch_fwd(const InRows& q, const InRows& k,
                              const InRows& v, const float* bias,
                              const float* mask, float* out, float* ms, int b_,
                              int n, int nh, int hd, int nw, int compact,
                              int wd, int hw, float scale,
                              cudaStream_t stream) {
  if (bad_dims(b_, n, nh, hd, nw, mask != nullptr, compact, wd, hw) ||
      out == nullptr || q.sr > kMaxRowStride || k.sr > kMaxRowStride ||
      v.sr > kMaxRowStride)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(nh, b_, row_split(nh * b_));
  attn_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, bias, mask, out, ms, n, nh, hd, nw, compact, wd, hw, scale);
  return cudaGetLastError();
}

// The same on the packed projection output qkv (b_, n, 3*nh*hd).
inline cudaError_t launch_packed_fwd(const float* qkv, const float* bias,
                                     const float* mask, float* out, float* ms,
                                     int b_, int n, int nh, int hd, int nw,
                                     int compact, int wd, int hw, float scale,
                                     cudaStream_t stream) {
  return launch_fwd(packed_rows(qkv, 0, n, nh, hd),
                    packed_rows(qkv, 1, n, nh, hd),
                    packed_rows(qkv, 2, n, nh, hd), bias, mask, out, ms, b_, n,
                    nh, hd, nw, compact, wd, hw, scale, stream);
}

// Floats of scratch launch_bwd needs: dl (b_, nh, n, n) and, where a
// problem is shared by several blocks, their shares of dk and dv.
inline long long bwd_scratch_floats(int b_, int n, int nh, int hd) {
  const int split = bwd_split(b_, nh);
  const long long per = (long long)b_ * nh * n;
  return per * n + (split > 1 ? 2LL * split * per * hd : 0);
}

// 16-byte copies of x's rows are aligned.
inline bool rows_aligned(const InRows& x) {
  return (reinterpret_cast<std::uintptr_t>(x.p) & 15) == 0 && x.sb % 4 == 0 &&
         x.sr % 4 == 0 && x.sh % 4 == 0;
}

// Backward on `stream`: the kernel, the sum of the blocks' shares of dk and
// dv where problems are shared, and the sum of dl over the windows where
// dbias is not null (where it is null, dl is not written).  g: (b_, n, nh*hd), the
// cotangent of out; ms (b_, n, 2nh) as a forward launch wrote it; dbias: in
// the bias's form.  Returns the first error.
inline cudaError_t launch_bwd(const InRows& q, const InRows& k,
                              const InRows& v, const float* bias,
                              const float* mask, const float* ms,
                              const float* g, const OutRows& dq,
                              const OutRows& dk, const OutRows& dv,
                              float* dbias, float* scratch, int b_, int n,
                              int nh, int hd, int nw, int compact, int wd,
                              int hw, float scale, cudaStream_t stream) {
  if (bad_dims(b_, n, nh, hd, nw, mask != nullptr, compact, wd, hw) ||
      ms == nullptr || q.sr > kMaxRowStride || k.sr > kMaxRowStride ||
      v.sr > kMaxRowStride)
    return cudaErrorInvalidValue;
  const long long c = (long long)nh * hd;
  const InRows gr{g, n * c, c, hd};
  const int vec = hd % 4 == 0 && rows_aligned(q) && rows_aligned(k) &&
                  rows_aligned(v) && rows_aligned(gr);
  // 16-byte copies of the dense bias's and the mask's rows
  const int vec_rows =
      n % 4 == 0 && (reinterpret_cast<std::uintptr_t>(bias) & 15) == 0 &&
      (reinterpret_cast<std::uintptr_t>(mask) & 15) == 0;
  const size_t smem = bwd_smem_bytes(n);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int split = bwd_split(b_, nh);
  float* part = split > 1 ? scratch + (size_t)b_ * nh * n * n : nullptr;
  const dim3 grid(nh, b_, split);
  attn_bwd_kernel<<<grid, bwd_warps(n) * 32, smem, stream>>>(
      q, k, v, gr, bias, mask, ms, dq, dk, dv,
      dbias != nullptr ? scratch : nullptr, part, n, nh, hd, nw, compact, wd,
      hw, scale, vec, vec_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (part != nullptr) {
    const long long outs = 2LL * b_ * nh * n * hd;
    dkv_sum_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, stream>>>(
        part, dk, dv, split, b_, n, nh, hd, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (dbias == nullptr) return cudaSuccess;
  const long long outs =
      compact ? (long long)nh * (2 * wd - 1) * hw * hw : (long long)nh * n * n;
  dbias_reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, stream>>>(
      scratch, dbias, b_, n, nh, compact, wd, hw);
  return cudaGetLastError();
}

// The same on the packed qkv (b_, n, 3*nh*hd), dq, dk and dv written packed
// into dqkv, the layout of qkv.
inline cudaError_t launch_packed_bwd(const float* qkv, const float* bias,
                                     const float* mask, const float* ms,
                                     const float* g, float* dqkv, float* dbias,
                                     float* scratch, int b_, int n, int nh,
                                     int hd, int nw, int compact, int wd,
                                     int hw, float scale,
                                     cudaStream_t stream) {
  return launch_bwd(packed_rows(qkv, 0, n, nh, hd),
                    packed_rows(qkv, 1, n, nh, hd),
                    packed_rows(qkv, 2, n, nh, hd), bias, mask, ms, g,
                    packed_rows(dqkv, 0, n, nh, hd),
                    packed_rows(dqkv, 1, n, nh, hd),
                    packed_rows(dqkv, 2, n, nh, hd), dbias, scratch, b_, n, nh,
                    hd, nw, compact, wd, hw, scale, stream);
}

}  // namespace attn
}  // namespace vitta
