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

#include "bf16.cuh"
#include "launches.cuh"
#include "tf32.cuh"

namespace vitta {
namespace attn {

// The largest window and head size the kernels take, and the largest stride
// between two tokens of q, k or v (a token's offset is taken in 32 bits).
constexpr int kNMax = 416;
constexpr int kMaxTokens = kNMax;
constexpr int kMaxHeadDim = 32;
constexpr long long kMaxRowStride = 0x7fffffff / kNMax;
// Row stride, in floats, of K, V and the query strips in shared memory:
// 36 puts the rows that mma's operand layouts read at once in different banks.
constexpr int kLd = kMaxHeadDim + 4;
constexpr int kDT = kMaxHeadDim / 8;       // 8-channel tiles of a head: 4

__host__ __device__ inline int round8(int v) { return (v + 7) & ~7; }

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

// ------------------------------------------------------------------- forward

// The forward kernel's shape: kFwdWarps warps a block, each owning one
// 16-row query strip of the problem at a time, the keys taken kFwdKeys at a
// time.  vitta_tpu_torch/tools/gemm_variants.py builds this source with
// other values of the two macros and times them.
#ifndef VITTA_ATTN_FWD_WARPS
#define VITTA_ATTN_FWD_WARPS 16
#endif
#ifndef VITTA_ATTN_FWD_KEYS
#define VITTA_ATTN_FWD_KEYS 32
#endif

constexpr int kFwdWarps = VITTA_ATTN_FWD_WARPS;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdKeys = VITTA_ATTN_FWD_KEYS;
constexpr int kFwdKT = kFwdKeys / 8;       // 8-key tiles of a chunk
static_assert(kFwdWarps >= 1 && kFwdWarps <= 16, "1 to 16 warps");
static_assert(kFwdKeys == 16 || kFwdKeys == 32 || kFwdKeys == 64,
              "chunks of 16, 32 or 64 keys");

// One (window, head) problem, or the query strips z, z + Z, ... of it where
// gridDim.z = Z > 1: out, and ms where it is not null.  Each warp takes its
// own strips; K and V of the problem lie in shared memory, (round8(n), kLd)
// each, rows past n zeros, then the bias's column offsets and each warp's
// (16, kLd) tile of its strip's q.
__global__ void __launch_bounds__(kFwdThreads, kFwdWarps <= 8 ? 2 : 1)
attn_fwd_kernel(const InRows q, const InRows k, const InRows v,
                const float* __restrict__ bias,
                const float* __restrict__ mask, float* __restrict__ out,
                float* __restrict__ ms, int n, int nh, int hd, int nw,
                int compact, int wd, int hw, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;     // mma's g and t
  const int keys = round8(n);
  float* Ks = smem;                            // (keys, kLd)
  float* Vs = Ks + keys * kLd;                 // (keys, kLd)
  int* coff = reinterpret_cast<int*>(Vs + keys * kLd);   // (keys)
  float* Qw = Vs + keys * (kLd + 1) + warp * 16 * kLd;   // (16, kLd)
  load_rows(Ks, k, b, h, 0, keys, n, hd, vec != 0, tid, kFwdThreads);
  load_rows(Vs, v, b, h, 0, keys, n, hd, vec != 0, tid, kFwdThreads);
  cp_async_commit();
  // bias[h, i, j] lies at roff(i) + coff[j]: dense (nh, n, n), roff =
  // (h n + i) n and coff = j; compact (nh, 2wd-1, hw, hw) with i = d1 hw + ii,
  // j = d2 hw + jj, roff = ((h (2wd-1) + d1 + wd-1) hw + ii) hw and coff =
  // jj - d2 hw hw.  Keys past n read key n - 1's and are not selected.
  for (int j = tid; j < keys; j += kFwdThreads) {
    const int jc = j < n ? j : n - 1;
    coff[j] = compact ? jc % hw - (jc / hw) * hw * hw : jc;
  }
  cp_async_wait_all();
  __syncthreads();

  const float* __restrict__ mask_b =
      mask != nullptr ? mask + (size_t)(b % nw) * n * n : nullptr;
  const int c = nh * hd;
  const int strips = (n + 15) / 16;
  for (int s = blockIdx.z * kFwdWarps + warp; s < strips;
       s += gridDim.z * kFwdWarps) {
    // the lane's rows i0 + gq + 8u, u = 0, 1 (clamped to n - 1 for reads)
    const int i0 = s * 16;
    int row[2];
    size_t roff[2], moff[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      row[u] = i0 + gq + 8 * u;
      const int i = row[u] < n ? row[u] : n - 1;
      if (compact) {
        const int d1 = i / hw;
        roff[u] = ((size_t)(h * (2 * wd - 1) + d1 + wd - 1) * hw + i -
                   d1 * hw) * hw;
      } else {
        roff[u] = ((size_t)h * n + i) * n;
      }
      moff[u] = (size_t)i * n;
    }
    // the strip's q through the warp's tile (zeros past row n and channel
    // hd), then as A fragments by ldmatrix, split once: (16 rows, 8
    // channels) a k step; lane l addresses row l % 8 of quarter l / 8
    __syncwarp();                    // the last strip's fragments are read
    load_rows(Qw, q, b, h, i0, 16, n, hd, vec != 0, lane, 32);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    FragA qf[kDT];
#pragma unroll
    for (int ks = 0; ks < kDT; ++ks) {
      float x[4];
      ldmatrix_x4(x, Qw + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                         8 * ks + 4 * (lane >> 4));
      qf[ks] = frag_a(x[0], x[1], x[2], x[3]);
    }

    // online softmax over the key chunks: the rows' running maximum, the
    // lane's share of their sums, and o, (16 rows, 8 channels) tiles
    float o[kDT][4];
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F}, lsum[2] = {0.f, 0.f};

    for (int j0 = 0; j0 < n; j0 += kFwdKeys) {
      // logits of the chunk's 8-key tiles; element e of a tile is row
      // gq + 8 (e >> 1), key 2 tq + (e & 1); tiles past n stay -inf and
      // are skipped (the same for the whole warp)
      float lg[kFwdKT][4];
#pragma unroll
      for (int nt = 0; nt < kFwdKT; ++nt) {
        const int jt = j0 + 8 * nt;
#pragma unroll
        for (int e = 0; e < 4; ++e) lg[nt][e] = -CUDART_INF_F;
        if (jt >= n) continue;
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < kDT; ++ks) {
          const int at = (jt + gq) * kLd + 8 * ks + tq;
          mma_3xtf32(sc, qf[ks], frag_b(Ks[at], Ks[at + 4]));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = e >> 1, j = jt + 2 * tq + (e & 1);
          const int jc = j < n ? j : n - 1;
          float l = fmaf(sc[e], scale, bias[roff[u] + coff[j]]);
          if (mask_b != nullptr) l += mask_b[moff[u] + jc];
          lg[nt][e] = j < n ? l : -CUDART_INF_F;
        }
      }
      // the rows' new maximum over the four lanes that share each row,
      // the correction of what was summed so far, and p in place of l
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float cmax = -CUDART_INF_F;
#pragma unroll
        for (int nt = 0; nt < kFwdKT; ++nt)
          cmax = fmaxf(cmax, fmaxf(lg[nt][2 * u], lg[nt][2 * u + 1]));
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
        const float mnew = fmaxf(mrow[u], cmax);
        const float corr = __expf(mrow[u] - mnew);
        mrow[u] = mnew;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kFwdKT; ++nt)
#pragma unroll
          for (int e = 2 * u; e < 2 * u + 2; ++e) {
            lg[nt][e] = __expf(lg[nt][e] - mnew);
            sum += lg[nt][e];
          }
        lsum[u] = fmaf(lsum[u], corr, sum);
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          o[dt][2 * u] *= corr;
          o[dt][2 * u + 1] *= corr;
        }
      }
      // o += p v: a tile of p is the A operand as it lies once a k step
      // maps column t to key 2t and t + 4 to key 2t + 1, and V's rows
      // follow that map
#pragma unroll
      for (int nt = 0; nt < kFwdKT; ++nt) {
        const int jt = j0 + 8 * nt;
        if (jt >= n) continue;
        const FragA pf = frag_a(lg[nt][0], lg[nt][2], lg[nt][1], lg[nt][3]);
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          const int at = (jt + 2 * tq) * kLd + 8 * dt + gq;
          mma_3xtf32(o[dt], pf, frag_b(Vs[at], Vs[at + kLd]));
        }
      }
    }

    // the rows' sums over the four lanes; out = o / sum, and m and the sum
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      lsum[u] += __shfl_xor_sync(0xffffffffu, lsum[u], 1);
      lsum[u] += __shfl_xor_sync(0xffffffffu, lsum[u], 2);
      if (row[u] >= n) continue;
      float* orow = out + ((size_t)b * n + row[u]) * c + h * hd;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * dt + 2 * tq + e;
          if (d < hd) orow[d] = o[dt][2 * u + e] / lsum[u];
        }
      if (ms != nullptr && tq == 0) {
        float* m = ms + ((size_t)b * n + row[u]) * 2 * nh + 2 * h;
        m[0] = mrow[u];
        m[1] = lsum[u];
      }
    }
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
constexpr int kBwdMaxWarps = kNMax / kBwdKeys;
constexpr int kBwdMaxThreads = kBwdMaxWarps * 32;
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

// The bias and mask rows i0 .. i0 + rows - 1 of a problem into Bs and Ws
// (rows, ldb), asynchronously, a warp a row; the compact bias's row
// i = d1 hw + ii is wd runs of hw floats, the run of block-column d2 at
// ((wd-1 + d1 - d2) hw + ii) hw.  Without a mask Ws is left as it is.
__device__ __forceinline__ void load_bias_rows(
    float* Bs, float* Ws, const float* __restrict__ bias_h,
    const float* __restrict__ mask_b, int i0, int rows, int n, int ldb,
    int compact, int wd, int hw, int vec_rows, int warp, int warps,
    int lane) {
  for (int r = warp; r < rows && i0 + r < n; r += warps) {
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
  auto load_bias = [&](int i0) {
    load_bias_rows(Bs, Ws, bias_h, mask_b, i0, kBwdStrip, n, ldb, compact,
                   wd, hw, vec_rows, warp, warps, lane);
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

__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// dk and dv of problems shared by `parts` blocks: each block's share, as
// the backward kernel left it in part, added in block order; dk times
// scale; rounded once where T is bfloat16.
template <class T>
__global__ void __launch_bounds__(256)
dkv_sum_kernel(const float* __restrict__ part, const Rows<T> dk,
               const Rows<T> dv, int parts, int b_, int n, int nh, int hd,
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
    store_value(dv.at(b, h) + (long long)j * dv.sr + d, acc);
  else
    store_value(dk.at(b, h) + (long long)j * dk.sr + d, acc * scale);
}

// dbias from the dl of all windows, (B_, nh, N, N): the sum over the
// windows in their order; for the compact form also over the block
// diagonal, as the collapse (bias.cu) sums it.
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

// The same sum for the dense form, 4 floats of dbias a thread (nh N N a
// multiple of 4, dl and dbias 16-byte aligned): each float the windows added
// in their order from zero, as dbias_reduce_kernel adds them, so the same
// bits; the loads of kReduceAhead windows are issued before their adds, and
// streamed (dl is read once).
constexpr int kReduceAhead = 4;
__global__ void __launch_bounds__(256)
dbias_reduce_x4_kernel(const float4* __restrict__ dl,
                       float4* __restrict__ dbias, int b_, long long per4) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= per4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b0 = 0; b0 < b_; b0 += kReduceAhead) {
    float4 v[kReduceAhead];
#pragma unroll
    for (int u = 0; u < kReduceAhead; ++u)
      if (b0 + u < b_) v[u] = __ldcs(dl + (long long)(b0 + u) * per4 + idx);
#pragma unroll
    for (int u = 0; u < kReduceAhead; ++u)
      if (b0 + u < b_) {
        acc.x += v[u].x;
        acc.y += v[u].y;
        acc.z += v[u].z;
        acc.w += v[u].w;
      }
  }
  dbias[idx] = acc;
}

// dbias (nh, n, n) from the dense form's dl (b_, nh, n, n): the x4 kernel
// where the sizes and pointers allow it, else dbias_reduce_kernel; the same
// bits either way.
inline cudaError_t launch_dense_dbias_reduce(const float* dl, float* dbias,
                                             int b_, int n, int nh,
                                             cudaStream_t stream) {
  const long long outs = (long long)nh * n * n;
  if (outs % 4 == 0 && (reinterpret_cast<std::uintptr_t>(dl) & 15) == 0 &&
      (reinterpret_cast<std::uintptr_t>(dbias) & 15) == 0) {
    const long long per4 = outs / 4;
    dbias_reduce_x4_kernel<<<(unsigned)((per4 + 255) / 256), 256, 0,
                             stream>>>(reinterpret_cast<const float4*>(dl),
                                       reinterpret_cast<float4*>(dbias), b_,
                                       per4);
    count_launch("dbias_reduce_x4_kernel");
  } else {
    dbias_reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, stream>>>(
        dl, dbias, b_, n, nh, 0, 0, 0);
    count_launch("dbias_reduce_kernel");
  }
  return cudaGetLastError();
}

inline int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || count <= 0)
    count = 132;
  return count;
}

// K and V (round8(n), kLd), the bias's column offsets and the warps' q
// tiles: 151,328 bytes at n = 392.
inline size_t fwd_smem_bytes(int n) {
  return ((size_t)round8(n) * (2 * kLd + 1) + kFwdWarps * 16 * kLd) *
         sizeof(float);
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

// 16-byte copies of x's rows are aligned.
inline bool rows_aligned(const InRows& x) {
  return (reinterpret_cast<std::uintptr_t>(x.p) & 15) == 0 && x.sb % 4 == 0 &&
         x.sr % 4 == 0 && x.sh % 4 == 0;
}

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
  const size_t smem = fwd_smem_bytes(n);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_fwd_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  const int vec =
      hd % 4 == 0 && rows_aligned(q) && rows_aligned(k) && rows_aligned(v);
  const dim3 grid(nh, b_, row_split(nh * b_));
  attn_fwd_kernel<<<grid, kFwdThreads, smem, stream>>>(
      q, k, v, bias, mask, out, ms, n, nh, hd, nw, compact, wd, hw, scale,
      vec);
  count_launch("attn_fwd_kernel");
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
  count_launch("attn_bwd_kernel");
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (part != nullptr) {
    const long long outs = 2LL * b_ * nh * n * hd;
    dkv_sum_kernel<float><<<(unsigned)((outs + 255) / 256), 256, 0,
                            stream>>>(part, dk, dv, split, b_, n, nh, hd,
                                      scale);
    count_launch("dkv_sum_kernel");
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (dbias == nullptr) return cudaSuccess;
  const long long outs =
      compact ? (long long)nh * (2 * wd - 1) * hw * hw : (long long)nh * n * n;
  dbias_reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, stream>>>(
      scratch, dbias, b_, n, nh, compact, wd, hw);
  count_launch("dbias_reduce_kernel");
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

// ---------------------------------------------------------------- bfloat16
//
// The packed attention at bfloat16, as vitta_tpu runs its Pallas kernels
// at the compute dtype (pallas_attention.py:358-514): qkv, out, g and dqkv
// bfloat16; the bias, the mask, ms, dl and dbias float32.  The products are
// mma.sync.m16n8k16 on bfloat16 operands (bf16.cuh), one per fragment.  The
// roundings are the TPU kernel's:
//   forward   l = (q k^T) * scale + bias + mask in float32; m = rowmax(l);
//             e = exp(l - m); s = rowsum(e) of the float32 e; the product
//             with v takes e rounded to bfloat16; out = (e v) / s rounded.
//   backward  e = exp(l - m) from the forward's m; inv = 1 / s;
//             gs = bfloat16(g * inv); dv = bfloat16(e)^T gs;
//             dp = g v^T; rs = rowsum(dp * e) * inv; dl = e (dp - rs) inv
//             (float32, into dbias); dq = (bfloat16(dl) k) * scale,
//             dk = (bfloat16(dl)^T q) * scale; dq, dk, dv rounded.
// Both kernels form a logit as the same float32 expression,
// fmaf(q.k, scale, bias) + mask, so that the backward's e is the forward's.
//
// Strips.  Both walk a problem's query rows 16 at a time.  With the dense
// bias a strip is 16 consecutive rows.  With the compact bias (wd <= 16) a
// strip holds rows ii-major: slot t = di wd + d1 is row d1 hw + ii with
// ii = s ips + di and ips = 16 / wd, so a strip holds every frame d1 of
// ips rows ii.  Its bias is then (2wd-1) contiguous spans of the compact
// tensor, bias[h, a, ii0 .. ii0 + ips - 1, :], a = d1 - d2 + wd - 1, and
// every element of the backward's compact partial (a, ii, jj) takes all of
// its terms, the frame pairs d1 - d2 = a - wd + 1, from one strip.  A block
// keeps its strips' rows in a table (rowtab).
//
// Staging.  The bias and mask rows a strip reads come into shared memory by
// cp.async in 16-byte units: the chunks that hold a run of floats, each
// chunk at the offset it has from a 16-byte boundary in device memory, so
// that a run starting anywhere is copied whole (a chunk never crosses a
// page; the floats around the run that it also holds are not read).  The
// reader finds float x of the run at (run's slot) + (its shift) + x.  The
// compact spans are then moved once to shift-free places, each thread the
// chunks it copied, so that bias(slot t, key j) lies at R(t) + K(j): a
// lookup is one add.  Rows past n, and the slots of a strip that hold no
// row, read slot 0's row or stale spans and are not selected.  Each strip's
// rows are asked for a whole strip ahead of their use.
//
// Forward, compact bias (attn_fwd_bf16_kernel).  A group of five warps
// takes one strip at a time, each warp a fifth of the keys, 16-key steps
// (80 keys at N = 392): the warp's logits stay in registers (40 a lane at
// N = 392), formed once from its q k^T tiles and the staged spans and mask.
// The rows' maxima go through shared memory to the group (a named barrier
// of 160 threads), e = exp(l - m) against the row's final maximum in place,
// its sum and bfloat16(e) v on the tensor cores, and the warps' partial o
// and sums meet in shared memory at a second named barrier, added in warp
// order; out of a strip is formed while the next strip's logits wait for
// its first barrier.  A block holds two or three groups (as many as fit 227
// KB) over one K and V; its groups take the problem's strips in turns, so
// no block-wide barrier runs inside the loop.  The q rows and compact spans
// are the group's, the mask rows of a warp's keys its own.
//
// Forward, dense bias (attn_fwd_dense_bf16_kernel; the heads route, the
// projection-fused chains and the packed op on a dense bias).  What bounds
// it: the bytes by the count (q, k, v and out, the bias and mask read once:
// 0.097 ms a Swin-T pass of 2 clips at 3.35 TB/s), but on the card the
// latency around each logit.  Every logit takes a float32 bias value and,
// in shifted windows, a float32 mask value (each (N, N) matrix 614 KB at N
// = 392, 12 times q, k and v), and a row's maximum must be final before
// any e is rounded, so a strip's logits all exist before its first exp.
// A block takes one head and a band of up to four strips (strips b, b +
// bands, ... of band b) and walks a run of windows, those that share a mask
// next to each other (dense_fwd_plan):
//  * the band's 16 rows a strip of the head's bias come into shared memory
//    once a run (16-byte cp.async copies where n % 4 == 0 and the bias lies
//    on a 16-byte boundary, 4-byte ones else), not once a window;
//  * four warps share a strip, its 16-key steps dealt out in turns (7 a
//    warp at N = 392); each keeps its logits in registers (56 a lane)
//    between the row maxima and e, and the group's maxima, then its
//    partial sums and o, meet in shared memory at two named barriers of
//    128 threads; s and o are the four warps' parts added in warp order,
//    each lane's sum its keys in order and the quad's four lanes pairs
//    first (tests/test_torch_attention_bf16_dense.py emulates it);
//  * the mask's values of a warp's logits come into those same registers a
//    window ahead, behind the previous window's exp and products, and the
//    logits form in place, fmaf(q.k, scale, bias) + mask: the mask's
//    device-memory latency never waits in front of a logit and costs no
//    register;
//  * K is double-buffered (the next window's K and q load during this
//    window), V single (it loads during the logits); K and V rows are 64
//    bytes with their 16-byte chunks XOR-swizzled, so that ldmatrix reads
//    eight rows from eight bank groups;
//  * 16 warps and 230 KB a block, one block an SM; runs are as long as
//    four blocks an SM's room still cover the grid, so a bias row comes
//    from L2 once every 4-6 windows at Swin's first stage.
// q k^T takes qk_tile's two mma.sync products on the same fragments as the
// backward (wgmma's float32 order is not known to match), so the backward's
// e is this kernel's to the bit (chip_smoke.py checks it at every Swin
// stage).  Tried and measured slower on the card (PERF.md, Findings): one
// warp a strip over all keys in two passes with the bias and mask rows
// staged (three or four warps an SM), the mask read from L2 in the logit
// loop, V double-buffered, 5, 6 or 8 warps a strip, 12 or 20 warps a
// block.
//
// Backward (attn_bwd_bf16_kernel).  The layout of the float32 kernel: a
// warp owns 32 keys (13 warps at N <= 416), dk and dv accumulate in
// registers, and the block walks the strips with two barriers each: after
// the logits (the rows' rs parts), after dl, dv, dk and the warps' dq
// shares.  gs = bfloat16(g / s) is formed in each warp's own B fragments of
// g.  The warps' rs parts and dq shares are added over 13 slots in warp
// order, those of warps a short window lacks held at zero, and rs, dp - rs
// and dl are rounded one operation at a time, as the reference rounds them.
// With the compact bias the strip's float32 dl goes to shared memory, and
// the block adds, for each (a, ii, jj) of the strip, its frame pairs in d1
// order, as _dbias_accum does (pallas_attention.py:384-400), and writes the
// (window, head) partial (B_, nh, 2wd-1, hw, hw) once; dbias_windows_kernel
// then adds the windows in their order.  The strip's dq and this collapse
// run while the next strip's logits wait for its first barrier.  Where
// blocks share a problem by strips, each strip's partials are wholly its
// block's, so the order holds.  With the dense
// bias each (window, head)'s partial is its dl: dl goes to the scratch
// (B_, nh, N, N) and dbias_reduce_kernel adds the windows in their order.
//
// The instances with kTap true also write bfloat16(e) of every (row, key)
// to e_tap (B_, nh, N, N), the value each product takes, and the backward
// writes dl to the scratch's first B_ nh N^2 floats with either bias: a
// check reads both and holds each output to its plain version on the
// kernel's own rounded e and dl.  The model's path runs the kTap false
// instances.  q, k, v, g and their gradients are moved in 16-byte units of
// 8 values: the C entries refuse rows that are not 16-byte aligned.

using InRowsB = Rows<const bf16>;
using OutRowsB = Rows<bf16>;

// Row stride, in bfloat16 values, of K, V, q and g in shared memory: 40
// values (80 bytes) put the eight rows an ldmatrix reads in different banks.
constexpr int kLdB = kMaxHeadDim + 8;
// The widest compact window depth: a strip holds every frame of a row.
constexpr int kMaxWd = 16;

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~15; }
// The least v >= x with v = 4 (mod 16): rows of that many floats put the
// rows 2 apart that mma's accumulator layout reads at once in other banks.
__host__ __device__ inline int ld4mod16(int x) {
  return x + (((4 - x) % 16) + 16) % 16;
}

// Rows r0 .. r0 + rows - 1 of head h of window b of x into dst (rows,
// kLdB), asynchronously, 16 bytes a copy; rows at or past n and channels at
// or past hd are zeros (hd a multiple of 8).
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const InRowsB& x,
                                               int b, int h, int r0, int rows,
                                               int n, int hd, int tid,
                                               int nthreads) {
  const bf16* base = x.at(b, h);
  constexpr int kChunks = kMaxHeadDim / 8;
  for (int idx = tid; idx < rows * kChunks; idx += nthreads) {
    const int r = idx / kChunks, c = (idx - r * kChunks) * 8;
    const bool ok = r0 + r < n && c < hd;
    cp_async16(dst + r * kLdB + c,
               ok ? base + (long long)(r0 + r) * x.sr + c : base, ok);
  }
}

// The query rows of a problem's strips (see above): ips 0 for the dense
// bias's consecutive rows, 16 / wd for the compact bias's ii-major ones.
struct Strips {
  int n, wd, hw, ips;
  __host__ __device__ int count() const {
    return ips ? (hw + ips - 1) / ips : (n + 15) / 16;
  }
  // The row in slot t (0 .. 15) of strip s, or -1.
  __device__ __forceinline__ int row(int s, int t) const {
    if (ips == 0) {
      const int i = 16 * s + t;
      return i < n ? i : -1;
    }
    const int di = t / wd, d1 = t - di * wd, ii = s * ips + di;
    return di < ips && ii < hw ? d1 * hw + ii : -1;
  }
};

// The table of the strips' rows, rowtab[16 s + t]: the row of slot t of
// strip s, or -1 - (slot 0's row) where the slot holds none.
__device__ __forceinline__ void fill_rowtab(int* rowtab, const Strips& sp,
                                            int tid, int nthreads) {
  for (int idx = tid; idx < 16 * sp.count(); idx += nthreads) {
    const int s = idx >> 4, i = sp.row(s, idx & 15);
    rowtab[idx] = i >= 0 ? i : -1 - sp.row(s, 0);
  }
}

// The row slot t's bias and mask are read from: its own, or slot 0's.
__device__ __forceinline__ int read_row(int r) { return r >= 0 ? r : -1 - r; }

// The 16 rows of a strip of x (head h of window b; rowtab of the strip)
// into dst (16, kLdB), asynchronously; slots without a row and channels at
// or past hd zeros.
__device__ __forceinline__ void load_strip_rows(bf16* dst, const InRowsB& x,
                                                int b, int h,
                                                const int* rows, int hd,
                                                int tid, int nthreads) {
  const bf16* base = x.at(b, h);
  for (int idx = tid; idx < 16 * (kMaxHeadDim / 8); idx += nthreads) {
    const int t = idx >> 2, c = (idx & 3) * 8, i = rows[t];
    const bool ok = i >= 0 && c < hd;
    cp_async16(dst + t * kLdB + c,
               ok ? base + (long long)i * x.sr + c : base, ok);
  }
}

// Float offset of p within its 16-byte chunk.
__device__ __forceinline__ int float_shift(const float* p) {
  return (int)((reinterpret_cast<std::uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ const float* chunk_base(const float* p) {
  return reinterpret_cast<const float*>(reinterpret_cast<std::uintptr_t>(p) &
                                        ~std::uintptr_t(15));
}

// 16-byte chunks that hold a run of len floats from p.
__device__ __forceinline__ int run_chunks(const float* p, int len) {
  return (float_shift(p) + len + 3) >> 2;
}

// Floats a staged run of len floats may take: its chunks with the shift.
__host__ __device__ inline int run_floats(int len) {
  return 4 * ((len + 6) >> 2);
}

// Keys k0 .. k0 + len - 1 of the 16 rows of a strip (rowtab of the strip)
// of the (n, n) matrix at base (a head's dense bias, a window's mask), into
// dst (16, ld): warp w0, w0 + wstep, ... take rows, their lanes the
// chunks.  Key j of slot t then lies at dst[t ld + float_shift(base +
// read_row(rows[t]) n + k0) + j - k0].
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* base,
                                           const int* rows, int n, int k0,
                                           int len, int w0, int wstep,
                                           int lane) {
  for (int t = w0; t < 16; t += wstep) {
    const float* src = base + (size_t)read_row(rows[t]) * n + k0;
    const float* cb = chunk_base(src);
    const int chunks = run_chunks(src, len);
    for (int c = lane; c < chunks; c += 32)
      cp_async<16>(dst + t * ld + 4 * c, cb + 4 * c, true);
  }
}

// The same for one warp, two lanes a row: lane 2t + c0 takes chunks c0,
// c0 + 2, ... of row t.
__device__ __forceinline__ void stage_rows_warp(float* dst, int ld,
                                                const float* base,
                                                const int* rows, int n,
                                                int k0, int len, int lane) {
  const int t = lane >> 1;
  const float* src = base + (size_t)read_row(rows[t]) * n + k0;
  const float* cb = chunk_base(src);
  const int chunks = run_chunks(src, len);
  for (int c = lane & 1; c < chunks; c += 2)
    cp_async<16>(dst + t * ld + 4 * c, cb + 4 * c, true);
}

// The compact bias of strip s (first row ii0): spans a = 0 .. 2wd-2 of
// bias_h[a, ii0 .. ii0 + rows - 1, :] into raw (2wd-1, slot), warps w0,
// w0 + wstep, ... a span, their lanes its chunks.
__device__ __forceinline__ void stage_spans(float* raw, int slot,
                                            const float* bias_h, int wd,
                                            int hw, int ii0, int rows,
                                            int w0, int wstep, int lane) {
  const int len = rows * hw;
  for (int a = w0; a < 2 * wd - 1; a += wstep) {
    const float* src = bias_h + ((size_t)a * hw + ii0) * hw;
    const float* cb = chunk_base(src);
    const int chunks = run_chunks(src, len);
    for (int c = lane; c < chunks; c += 32)
      cp_async<16>(raw + a * slot + 4 * c, cb + 4 * c, true);
  }
}

// The same chunks, once they have landed (each thread its own), moved to
// their shift-free places: element (a, ii, jj) to dst[a span + (ii - ii0)
// hw + jj], span = ips hw.
__device__ __forceinline__ void align_spans(float* dst, int span,
                                            const float* raw, int slot,
                                            const float* bias_h, int wd,
                                            int hw, int ii0, int rows,
                                            int w0, int wstep, int lane) {
  const int len = rows * hw;
  for (int a = w0; a < 2 * wd - 1; a += wstep) {
    const float* src = bias_h + ((size_t)a * hw + ii0) * hw;
    const int sh = float_shift(src), chunks = run_chunks(src, len);
    for (int c = lane; c < chunks; c += 32) {
      const float4 x =
          *reinterpret_cast<const float4*>(raw + a * slot + 4 * c);
      const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 4 * c + e - sh;
        if (p >= 0 && p < len) dst[a * span + p] = v[e];
      }
    }
  }
}

// s = q k^T of one 8-key tile from the strip's q fragments and K in shared
// memory: one ldmatrix gives the tile's B fragments over all 32 channels.
__device__ __forceinline__ void qk_tile(float (&sc)[4],
                                        const unsigned (&qf)[2][4],
                                        const bf16* Ks, int jt, int lane) {
  unsigned kb[4];
  ldsm_x4(kb, Ks + (jt + (lane & 7)) * kLdB + 8 * (lane >> 3));
#pragma unroll
  for (int e = 0; e < 4; ++e) sc[e] = 0.f;
  const unsigned b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
  mma_bf16(sc, qf[0], b0);
  mma_bf16(sc, qf[1], b1);
}

// The compact bias's place of slot t, R(t) = (wd-1 + d1) span + di hw, and
// of key j, K(j) = jj - d2 span: bias(t, j) lies at R(t) + K(j) of the
// aligned spans, whose stride span (>= ips hw) each kernel chooses for the
// banks its lanes read at once.
__device__ __forceinline__ int span_row(int t, int wd, int hw, int ips,
                                        int span) {
  const int tt = t < ips * wd ? t : 0, di = tt / wd;
  return (wd - 1 + tt - di * wd) * span + di * hw;
}
__device__ __forceinline__ int span_key(int j, int n, int hw, int span) {
  const int jc = min(j, n - 1), d2 = jc / hw;
  return jc - d2 * hw - d2 * span;
}

// ----------------------------------------------------- bfloat16 forward

constexpr int kFwdGroupWarps = 5;                 // a strip's keys, 5 ways
constexpr int kFwdGroupThreads = kFwdGroupWarps * 32;
constexpr int kFwdMaxGroups = 3;
constexpr int kFwdMaxSteps = 6;                   // 16-key steps a warp
constexpr int kRedLd = 40;                        // a partial o row, floats
static_assert(kFwdGroupWarps * kFwdMaxSteps * 16 >= kNMax,
              "the group's warps cover kNMax keys");

// The compact forward's shared memory, in bytes from its start: K, V, the
// strips' rows and each key's K(j); then per group its two q strips, the
// warps' row maxima, sums and partial o, the rows' final maxima, the
// compact spans as copied and shift-free, and each warp's staged mask rows.
struct FwdBf16Layout {
  int steps, kw, keys, wld, span, slot;
  size_t vs, rowtab, kd, group0, g_max, g_sum, g_mfin, g_o, g_raw, g_spans,
      g_wm, group_bytes;
  __host__ __device__ FwdBf16Layout(int n, int wd, int hw, bool with_mask) {
    const Strips sp{n, wd, hw, 16 / wd};
    steps = ((n + 15) / 16 + kFwdGroupWarps - 1) / kFwdGroupWarps;
    kw = 16 * steps;
    keys = kFwdGroupWarps * kw;
    wld = run_floats(kw);
    // lanes gq read slots gq, frames d1 = gq: span = 8 (mod 32) puts 8
    // frames' rows in 4 bank groups, two to a group
    span = sp.ips * hw + ((8 - sp.ips * hw) % 32 + 32) % 32;
    slot = run_floats(sp.ips * hw);
    vs = (size_t)keys * kLdB * 2;
    rowtab = 2 * vs;
    kd = rowtab + (size_t)16 * sp.count() * 4;
    group0 = align16(kd + (size_t)keys * 4);
    g_max = 2 * 16 * kLdB * 2;
    g_sum = g_max + kFwdGroupWarps * 16 * 4;
    g_mfin = g_sum + kFwdGroupWarps * 16 * 4;
    g_o = g_mfin + 16 * 4;
    g_raw = g_o + (size_t)kFwdGroupWarps * 16 * kRedLd * 4;
    g_spans = g_raw + (size_t)(2 * wd - 1) * slot * 4;
    g_wm = align16(g_spans + (size_t)(2 * wd - 1) * span * 4);
    group_bytes =
        align16(g_wm + (with_mask ? (size_t)kFwdGroupWarps * 16 * wld * 4 : 0));
  }
  __host__ __device__ size_t bytes(int groups) const {
    return group0 + groups * group_bytes;
  }
};

// The group's 160 threads meet at named barrier 1 + grp (0 is the block's).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "n"(kFwdGroupThreads)
               : "memory");
}

template <bool kTap>
__global__ void __launch_bounds__(kFwdMaxGroups * kFwdGroupThreads, 1)
attn_fwd_bf16_kernel(const InRowsB q, const InRowsB k, const InRowsB v,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask, bf16* __restrict__ out,
                     float* __restrict__ ms, bf16* __restrict__ e_tap, int n,
                     int nh, int hd, int nw, int wd, int hw, float scale) {
  extern __shared__ __align__(16) unsigned char attn_smem_bf16[];
  const FwdBf16Layout L(n, wd, hw, mask != nullptr);
  const int groups = blockDim.x / kFwdGroupThreads;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / kFwdGroupWarps, wg = warp - grp * kFwdGroupWarps;
  const int gt = tid - grp * kFwdGroupThreads;
  const int gq = lane >> 2, tq = lane & 3;       // mma's g and t
  unsigned char* sm = attn_smem_bf16;
  bf16* Ks = reinterpret_cast<bf16*>(sm);                  // (keys, kLdB)
  bf16* Vs = reinterpret_cast<bf16*>(sm + L.vs);           // (keys, kLdB)
  int* rowtab = reinterpret_cast<int*>(sm + L.rowtab);     // (strips, 16)
  int* kd = reinterpret_cast<int*>(sm + L.kd);             // (keys): K(j)
  unsigned char* gs = sm + L.group0 + grp * L.group_bytes;
  bf16* Qg = reinterpret_cast<bf16*>(gs);                  // (2, 16, kLdB)
  float* red_max = reinterpret_cast<float*>(gs + L.g_max); // (5, 16)
  float* red_sum = reinterpret_cast<float*>(gs + L.g_sum); // (5, 16)
  float* mfin = reinterpret_cast<float*>(gs + L.g_mfin);   // (16)
  float* red_o = reinterpret_cast<float*>(gs + L.g_o);     // (5, 16, kRedLd)
  float* raw = reinterpret_cast<float*>(gs + L.g_raw);     // (2wd-1, slot)
  float* spans = reinterpret_cast<float*>(gs + L.g_spans); // (2wd-1, span)
  float* wm = reinterpret_cast<float*>(gs + L.g_wm) + wg * 16 * L.wld;
  const Strips sp{n, wd, hw, 16 / wd};
  const int strips = sp.count();
  const int kb = wg * L.kw;                      // the warp's first key
  const int klen = min(L.kw, n - kb);            // its keys below n
  const float* __restrict__ bias_h = bias + (size_t)h * (2 * wd - 1) * hw * hw;
  const float* __restrict__ mask_b =
      mask != nullptr ? mask + (size_t)(b % nw) * n * n : nullptr;

  // strip s's q rows into Qg buffer qb and compact spans into raw (the
  // group's), and the mask rows of the warp's keys (its own)
  auto stage_group = [&](int s, int qb) {
    load_strip_rows(Qg + qb * 16 * kLdB, q, b, h, rowtab + 16 * s, hd, gt,
                    kFwdGroupThreads);
    const int ii0 = s * sp.ips;
    stage_spans(raw, L.slot, bias_h, wd, hw, ii0, min(sp.ips, hw - ii0), wg,
                kFwdGroupWarps, lane);
  };
  auto align_group = [&](int s) {
    const int ii0 = s * sp.ips;
    align_spans(spans, L.span, raw, L.slot, bias_h, wd, hw, ii0,
                min(sp.ips, hw - ii0), wg, kFwdGroupWarps, lane);
  };
  auto stage_warp = [&](int s) {
    if (klen > 0 && mask_b != nullptr)
      stage_rows_warp(wm, L.wld, mask_b, rowtab + 16 * s, n, kb, klen, lane);
  };

  load_rows_bf16(Ks, k, b, h, 0, L.keys, n, hd, tid, blockDim.x);
  load_rows_bf16(Vs, v, b, h, 0, L.keys, n, hd, tid, blockDim.x);
  fill_rowtab(rowtab, sp, tid, blockDim.x);
  for (int j = tid; j < L.keys; j += blockDim.x)
    kd[j] = span_key(j, n, hw, L.span);
  __syncthreads();                               // rowtab
  int s = blockIdx.z * groups + grp;
  const int sstep = gridDim.z * groups;
  if (s < strips) {
    stage_group(s, 0);
    stage_warp(s);
  }
  cp_async_commit();
  cp_async_wait_all();
  if (s < strips) align_group(s);
  __syncthreads();

  // the compact bias's places of the lane's slots gq and gq + 8
  int rsp[2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
    rsp[u] = span_row(gq + 8 * u, wd, hw, sp.ips, L.span);
  const int c = nh * hd;
  // out of strip ps = (the warps' o) / (their sums), each added in warp
  // order, and the rows' maximum and sum: run after the next strip's
  // logits, before its first barrier, which the next writes of the
  // group's partials wait behind
  auto finish = [&](int ps) {
    if (ps < 0) return;
    const int* prow = rowtab + 16 * ps;
    for (int p = gt; p < 16 * 16; p += kFwdGroupThreads) {
      const int r = p >> 4, d = 2 * (p & 15);
      const int i = prow[r];
      if (i < 0 || d >= hd) continue;
      float sum = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
      for (int w = 0; w < kFwdGroupWarps; ++w) {
        sum += red_sum[w * 16 + r];
        const float2 x = *reinterpret_cast<const float2*>(
            red_o + (w * 16 + r) * kRedLd + d);
        o0 += x.x;
        o1 += x.y;
      }
      *reinterpret_cast<unsigned*>(out + ((size_t)b * n + i) * c + h * hd +
                                   d) = pack_bf16(o0 / sum, o1 / sum);
      if (ms != nullptr && d == 0) {
        float* mp = ms + ((size_t)b * n + i) * 2 * nh + 2 * h;
        mp[0] = mfin[r];
        mp[1] = sum;
      }
    }
  };
  int qb = 0, prev = -1;
  for (; s < strips; s += sstep, qb ^= 1) {
    // the next strip's group rows, a whole strip ahead
    if (s + sstep < strips) stage_group(s + sstep, qb ^ 1);
    cp_async_commit();
    cp_async_wait<1>();          // the warp's rows of strip s
    __syncwarp();
    const int* rows = rowtab + 16 * s;
    // the lane's slots gq and gq + 8: their rows and where their mask
    // values lie
    int row[2], moff[2] = {0, 0};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = gq + 8 * u, r = rows[t], rr = read_row(r);
      row[u] = r;
      if (mask_b != nullptr)
        moff[u] = t * L.wld + float_shift(mask_b + (size_t)rr * n + kb) - kb;
    }
    unsigned qf[2][4];
    const bf16* Qb = Qg + qb * 16 * kLdB;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldsm_x4(qf[ks], Qb + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLdB +
                          16 * ks + 8 * (lane >> 4));

    // the logits of the warp's keys, once: element e of tile (st, hf) is
    // row slot gq + 8 (e >> 1), key kb + 16 st + 8 hf + 2 tq + (e & 1)
    float lg[kFwdMaxSteps][2][4];
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int st = 0; st < kFwdMaxSteps; ++st)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int jt = kb + 16 * st + 8 * hf;
#pragma unroll
        for (int e = 0; e < 4; ++e) lg[st][hf][e] = -CUDART_INF_F;
        if (st >= L.steps || jt >= n) continue;
        float sc[4];
        qk_tile(sc, qf, Ks, jt, lane);
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int j = jt + 2 * tq + cc;
          const int kj = kd[j];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * u + cc;
            float l = fmaf(sc[e], scale, spans[rsp[u] + kj]);
            if (mask_b != nullptr) l += wm[moff[u] + j];
            l = j < n ? l : -CUDART_INF_F;
            lg[st][hf][e] = l;
            mx[u] = fmaxf(mx[u], l);
          }
        }
      }
    __syncwarp();                // the warp's rows are read
    if (s + sstep < strips) stage_warp(s + sstep);
    cp_async_commit();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      if (tq == 0) red_max[wg * 16 + gq + 8 * u] = mx[u];
    }
    finish(prev);
    group_sync(grp);
    float m[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      m[u] = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kFwdGroupWarps; ++w)
        m[u] = fmaxf(m[u], red_max[w * 16 + gq + 8 * u]);
      if (wg == 0 && tq == 0) mfin[gq + 8 * u] = m[u];
    }

    // e = exp(l - m), its sum and o += bfloat16(e) v over 16 keys a step:
    // the two 8-key tiles of e are the A fragment as they lie (keys past n
    // hold -inf: e = 0)
    float o[kDT][4];
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int st = 0; st < kFwdMaxSteps; ++st) {
      const int j0 = kb + 16 * st;
      if (st >= L.steps || j0 >= n) continue;
      float ex[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = __expf(lg[st][hf][e] - m[e >> 1]);
          ex[hf][e] = x;
          lsum[e >> 1] += x;
          const int j = j0 + 8 * hf + 2 * tq + (e & 1);
          if (kTap && j < n && row[e >> 1] >= 0)
            e_tap[(((size_t)b * nh + h) * n + row[e >> 1]) * n + j] =
                __float2bfloat16_rn(x);
        }
      const unsigned pa[4] = {pack_bf16(ex[0][0], ex[0][1]),
                              pack_bf16(ex[0][2], ex[0][3]),
                              pack_bf16(ex[1][0], ex[1][1]),
                              pack_bf16(ex[1][2], ex[1][3])};
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        unsigned vb[4];
        ldsm_x4_trans(vb, Vs + (j0 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                   kLdB + 16 * dp + 8 * (lane >> 4));
        const unsigned b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
        mma_bf16(o[2 * dp], pa, b0);
        mma_bf16(o[2 * dp + 1], pa, b1);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      lsum[u] += __shfl_xor_sync(0xffffffffu, lsum[u], 1);
      lsum[u] += __shfl_xor_sync(0xffffffffu, lsum[u], 2);
      const int r = gq + 8 * u;
      if (tq == 0) red_sum[wg * 16 + r] = lsum[u];
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<float2*>(red_o + (wg * 16 + r) * kRedLd + 8 * dt +
                                   2 * tq) =
            make_float2(o[dt][2 * u], o[dt][2 * u + 1]);
    }
    // the next strip's group rows have landed (this thread's): its spans
    // to their shift-free places, read by all after the barrier
    cp_async_wait<1>();
    if (s + sstep < strips) align_group(s + sstep);
    group_sync(grp);

    prev = s;
  }
  finish(prev);
}

// ---------------------------------------- bfloat16 forward, dense bias

// A K or V row in shared memory: 32 channels (64 bytes; channels past hd
// zeros), its 16-byte chunk c at chunk c ^ ((r >> 1) & 3), so that the
// eight rows an ldmatrix reads fall in eight different bank groups.
constexpr int kLdKV = kMaxHeadDim;

__host__ __device__ inline int kv_at(int r, int c) {
  return r * kLdKV + ((c ^ ((r >> 1) & 3)) << 3);
}

// The dense forward's shape (see the note above): kDenseSplit warps share
// a strip, its 16-key steps dealt out in turns (the order of s and o that
// dense_fwd_plan's mirror and the CPU tests emulate); at most
// kDenseMaxWarps warps a block (each keeps its logits, kDenseSteps 16-key
// steps, in registers); runs of windows short enough for kDenseWaves
// blocks an SM's room.  The two macros exist only for
// vitta_tpu_torch/tools/attention_bf16_sites.py --dense, which builds this
// source with other values of them and times those builds; nothing else
// sets them.
constexpr int kDenseSplit = 4;
#ifndef VITTA_DENSE_FWD_MAX_WARPS
#define VITTA_DENSE_FWD_MAX_WARPS 16
#endif
#ifndef VITTA_DENSE_FWD_WAVES
#define VITTA_DENSE_FWD_WAVES 4
#endif
constexpr int kDenseMaxWarps = VITTA_DENSE_FWD_MAX_WARPS;
constexpr int kDenseWaves = VITTA_DENSE_FWD_WAVES;
// 16-key steps a warp takes at most
constexpr int kDenseSteps = (kNMax / 16 + kDenseSplit - 1) / kDenseSplit;
constexpr int kDenseRedLd = kMaxHeadDim + 4;     // a partial o row, floats
constexpr int kSmemPerBlock = 232448;
static_assert(kDenseSplit >= 1 && kDenseMaxWarps % kDenseSplit == 0 &&
                  kDenseMaxWarps / kDenseSplit <= 15,
              "whole groups of warps, a named barrier each");

// What dense_fwd_plan chooses, and the shared memory it lays out: K in two
// buffers and V in one (keys, kLdKV), then per strip of the block its two
// q buffers (16, kLdB), its 16 rows of the head's bias (16, ldb) and its
// group's partial maxima, sums and o (split, 16) + (split, 16) + (split,
// 16, kDenseRedLd) floats.
struct DenseFwdPlan {
  int strips;    // 16-row strips of a problem
  int keys;      // keys the passes walk: n rounded up to 16
  int ldb;       // floats a staged bias row: keys + 8 (8 mod 16)
  int slots;     // strips a block, kDenseSplit warps each
  int bands;     // blocks a (window run, head): strips b, b + bands, ...
  int run;       // windows a block walks
  int runs;      // blocks a (band, head)
  int vec;       // 16-byte copies of the bias rows, 8-byte mask reads
  int blocks;    // nh * bands * runs
  int smem;      // bytes a block
  __host__ __device__ int kv_bytes() const { return 3 * keys * kLdKV * 2; }
  __host__ __device__ int strip_bytes() const {
    return 2 * 16 * kLdB * 2 + 16 * ldb * 4 +
           kDenseSplit * 16 * (kDenseRedLd + 2) * 4;
  }
  __host__ __device__ int strip_off(int slot) const {
    return kv_bytes() + slot * strip_bytes();
  }
};

// The plan of a call, by shape alone: b_ windows of n tokens, nh heads,
// nw masks (0 without one); vec where n % 4 == 0 and the bias and mask lie
// on 16-byte boundaries; sms, the card's SMs.  A run holds whole groups of
// the windows that share a mask (b_ / nw of them).
inline DenseFwdPlan dense_fwd_plan(int b_, int n, int nh, int nw, bool vec,
                                   int sms) {
  DenseFwdPlan p;
  p.strips = (n + 15) / 16;
  p.keys = 16 * p.strips;
  p.ldb = p.keys + 8;
  p.vec = vec ? 1 : 0;
  const int most = kDenseMaxWarps / kDenseSplit;
  int fit = (kSmemPerBlock - p.kv_bytes()) / p.strip_bytes();
  fit = fit < most ? fit : most;
  fit = fit < p.strips ? fit : p.strips;
  fit = fit < 1 ? 1 : fit;
  p.bands = (p.strips + fit - 1) / fit;
  p.slots = (p.strips + p.bands - 1) / p.bands;
  p.smem = p.kv_bytes() + p.slots * p.strip_bytes();
  const int per_sm = kSmemPerBlock / p.smem;
  const int target = kDenseWaves * sms * (per_sm < 1 ? 1 : per_sm);
  const int group = nw > 0 ? b_ / nw : 1, groups = b_ / group;
  const int units = nh * p.bands;
  int per_run = units * groups / target;
  per_run = per_run < 1 ? 1 : (per_run > groups ? groups : per_run);
  p.runs = (groups + per_run - 1) / per_run;
  p.run = group * ((groups + p.runs - 1) / p.runs);
  p.blocks = units * p.runs;
  return p;
}

// s = q k^T of one 8-key tile from the strip's q fragments and K in its
// chunk order (kv_at): qk_tile's two products on the same fragments.
__device__ __forceinline__ void qk_tile_kv(float (&sc)[4],
                                           const unsigned (&qf)[2][4],
                                           const bf16* Ks, int jt, int lane) {
  unsigned kb[4];
  ldsm_x4(kb, Ks + kv_at(jt + (lane & 7), lane >> 3));
#pragma unroll
  for (int e = 0; e < 4; ++e) sc[e] = 0.f;
  const unsigned b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
  mma_bf16(sc, qf[0], b0);
  mma_bf16(sc, qf[1], b1);
}

template <bool kTap, bool kMask>
__global__ void __launch_bounds__(kDenseMaxWarps * 32)
attn_fwd_dense_bf16_kernel(const InRowsB q, const InRowsB k, const InRowsB v,
                           const float* __restrict__ bias,
                           const float* __restrict__ mask,
                           bf16* __restrict__ out, float* __restrict__ ms,
                           bf16* __restrict__ e_tap, int b_, int n, int nh,
                           int hd, int nw, float scale, const DenseFwdPlan P) {
  extern __shared__ __align__(16) unsigned char dense_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;       // mma's g and t
  const int slot = warp / kDenseSplit, part = warp - slot * kDenseSplit;
  const int gt = part * 32 + lane;               // thread of the strip's group
  const int h = blockIdx.x % nh, unit = blockIdx.x / nh;
  const int band = unit % P.bands, run = unit / P.bands;
  const int s = band + P.bands * slot;           // the group's strip
  const bool active = s < P.strips;
  const int i0 = 16 * s;
  const int c = nh * hd, steps = P.keys / 16;
  // the run's windows, those of one mask next to each other: window o of
  // the order is (o mod group) nw + o / group, its mask o / group
  const int group = kMask ? b_ / nw : 1;
  const int o0 = run * P.run, o1 = min(b_, o0 + P.run);
  auto window = [&](int o) {
    return kMask ? (o % group) * nw + o / group : o;
  };
  bf16* Kb = reinterpret_cast<bf16*>(dense_smem);          // (2, keys, kLdKV)
  bf16* Vs = Kb + 2 * P.keys * kLdKV;                      // (keys, kLdKV)
  unsigned char* st_ = dense_smem + P.strip_off(slot);
  bf16* Qs = reinterpret_cast<bf16*>(st_);                 // (2, 16, kLdB)
  float* Bs = reinterpret_cast<float*>(st_ + 2 * 16 * kLdB * 2);
  float* red_max = Bs + 16 * P.ldb;                        // (split, 16)
  float* red_sum = red_max + kDenseSplit * 16;             // (split, 16)
  float* red_o = red_sum + kDenseSplit * 16;  // (split, 16, kDenseRedLd)
  // the group's 128 threads meet at named barrier 1 + slot
  auto group_sync = [&]() {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + slot), "n"(kDenseSplit * 32)
                 : "memory");
  };

  // K or V (x) of window b into dst (keys past n zeros), all threads
  auto load_kv = [&](bf16* dst, const InRowsB& x, int b) {
    const bf16* xp = x.at(b, h);
    for (int idx = tid; idx < 4 * P.keys; idx += blockDim.x) {
      const int r = idx >> 2, ch = idx & 3;
      const bool ok = r < n && 8 * ch < hd;
      cp_async16(dst + kv_at(r, ch), ok ? xp + (long long)r * x.sr + 8 * ch : xp,
                 ok);
    }
  };
  // the strip's q of window b into its buffer qb, the group's threads
  auto load_q = [&](int qb, int b) {
    if (!active) return;
    const bf16* qp = q.at(b, h);
    for (int idx = gt; idx < 64; idx += kDenseSplit * 32) {
      const int r = idx >> 2, ch = idx & 3;
      const bool ok = i0 + r < n && 8 * ch < hd;
      cp_async16(Qs + (qb * 16 + r) * kLdB + 8 * ch,
                 ok ? qp + (long long)(i0 + r) * q.sr + 8 * ch : qp, ok);
    }
  };

  // the strip's 16 rows of the head's bias, once a run (rows past n zeros):
  // warp `part` of the group takes rows part, part + split, ...
  if (active) {
    const float* bias_h = bias + (size_t)h * n * n;
    for (int r = part; r < 16; r += kDenseSplit) {
      const bool ok = i0 + r < n;
      const float* row = ok ? bias_h + (size_t)(i0 + r) * n : bias_h;
      if (P.vec)
        for (int x = 4 * lane; x < n; x += 128)
          cp_async<16>(Bs + r * P.ldb + x, row + x, ok);
      else
        for (int x = lane; x < n; x += 32)
          cp_async<4>(Bs + r * P.ldb + x, row + x, ok);
    }
  }
  // K and q of the first window, then its V
  load_kv(Kb, k, window(o0));
  load_q(0, window(o0));
  cp_async_commit();
  load_kv(Vs, v, window(o0));
  cp_async_commit();
  // the lane's rows gq and gq + 8 of the staged bias, at key 2 tq; of the
  // mask, the rows clamped to n - 1 and keys to the row's last pair
  const float* br0 = Bs + gq * P.ldb + 2 * tq;
  const float* br1 = br0 + 8 * P.ldb;
  const int mrow0 = min(i0 + gq, n - 1), mrow1 = min(i0 + gq + 8, n - 1);
  const int jlast = P.vec ? n - 2 : n - 1;
  // the warp's logits: lg[i][hf][e] is row gq + 8 (e >> 1), key 16 st +
  // 8 hf + 2 tq + (e & 1) of step st = part + split i.  With a mask they
  // first hold the mask's values, loaded a window ahead.
  float lg[kDenseSteps][2][4];
  auto load_mask = [&](int o) {
    if (!kMask || !active) return;
    const float* __restrict__ mw = mask + (size_t)(o / group) * n * n;
#pragma unroll
    for (int i = 0; i < kDenseSteps; ++i) {
      const int st = part + kDenseSplit * i;
      if (st >= steps) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int jm = min(16 * st + 8 * hf + 2 * tq, jlast);
        const float* m0 = mw + (size_t)mrow0 * n + jm;
        const float* m1 = mw + (size_t)mrow1 * n + jm;
        if (P.vec) {
          const float2 a0 = __ldg(reinterpret_cast<const float2*>(m0));
          const float2 a1 = __ldg(reinterpret_cast<const float2*>(m1));
          lg[i][hf][0] = a0.x, lg[i][hf][1] = a0.y;
          lg[i][hf][2] = a1.x, lg[i][hf][3] = a1.y;
        } else {
          lg[i][hf][0] = __ldg(m0), lg[i][hf][1] = __ldg(m0 + (jm + 1 < n));
          lg[i][hf][2] = __ldg(m1), lg[i][hf][3] = __ldg(m1 + (jm + 1 < n));
        }
      }
    }
  };
  load_mask(o0);
  for (int o = o0; o < o1; ++o) {
    const int b = window(o), kb = (o - o0) & 1;
    // the next window's K and q load during this one, this window's V
    // during its logits
    if (o + 1 < o1) {
      load_kv(Kb + (kb ^ 1) * P.keys * kLdKV, k, window(o + 1));
      load_q(kb ^ 1, window(o + 1));
    }
    cp_async_commit();
    cp_async_wait<2>();
    __syncthreads();                             // K, q and the bias

    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    if (active) {
      const bf16* Ks = Kb + kb * P.keys * kLdKV;
      unsigned qf[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldsm_x4(qf[ks], Qs + (kb * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                 kLdB + 16 * ks + 8 * (lane >> 4));
      // the logits fmaf(q.k, scale, bias) + mask of the warp's steps, keys
      // past n -inf, and the warp's row maxima, then the group's
#pragma unroll
      for (int i = 0; i < kDenseSteps; ++i) {
        const int st = part + kDenseSplit * i;
        if (st >= steps) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int jt = 16 * st + 8 * hf, j = jt + 2 * tq;
          float sc[4];
          qk_tile_kv(sc, qf, Ks, jt, lane);
          const float2 b0 = *reinterpret_cast<const float2*>(br0 + jt);
          const float2 b1 = *reinterpret_cast<const float2*>(br1 + jt);
          const float bb[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = fmaf(sc[e], scale, bb[e]);
            float l = kMask ? x + lg[i][hf][e] : x;
            if (jt + 8 > n && j + (e & 1) >= n)  // the tile crosses n
              l = -CUDART_INF_F;
            lg[i][hf][e] = l;
            m[e >> 1] = fmaxf(m[e >> 1], l);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        m[u] = fmaxf(m[u], __shfl_xor_sync(0xffffffffu, m[u], 1));
        m[u] = fmaxf(m[u], __shfl_xor_sync(0xffffffffu, m[u], 2));
        if (tq == 0) red_max[part * 16 + gq + 8 * u] = m[u];
      }
      group_sync();                              // the group's maxima
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int w = 0; w < kDenseSplit; ++w)
          m[u] = fmaxf(m[u], red_max[w * 16 + gq + 8 * u]);
    }
    cp_async_wait<1>();
    __syncthreads();                             // V

    if (active) {
      // e = exp(l - m), the lane's sums in key order and o += bfloat16(e) v
      // over 16 keys a step (the two 8-key tiles of e are the A fragment
      // as they lie)
      float o_[kDT][4];
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o_[dt][e] = 0.f;
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kDenseSteps; ++i) {
        const int st = part + kDenseSplit * i;
        if (st >= steps) continue;
        const int j0 = 16 * st;
        float ex[2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = __expf(lg[i][hf][e] - m[e >> 1]);
            ex[hf][e] = x;
            sum[e >> 1] += x;
            const int j = j0 + 8 * hf + 2 * tq + (e & 1);
            const int r = i0 + gq + 8 * (e >> 1);
            if (kTap && j < n && r < n)
              e_tap[(((size_t)b * nh + h) * n + r) * n + j] =
                  __float2bfloat16_rn(x);
          }
        const unsigned pa[4] = {pack_bf16(ex[0][0], ex[0][1]),
                                pack_bf16(ex[0][2], ex[0][3]),
                                pack_bf16(ex[1][0], ex[1][1]),
                                pack_bf16(ex[1][2], ex[1][3])};
#pragma unroll
        for (int dp = 0; dp < kDT / 2; ++dp) {
          unsigned vb[4];
          ldsm_x4_trans(vb, Vs + kv_at(j0 + (lane & 7) + 8 * ((lane >> 3) & 1),
                                       2 * dp + (lane >> 4)));
          const unsigned b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
          mma_bf16(o_[2 * dp], pa, b0);
          mma_bf16(o_[2 * dp + 1], pa, b1);
        }
      }
      // the warp's sums (the quad's four, pairs first) and partial o
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], 1);
        sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], 2);
        const int r = gq + 8 * u;
        if (tq == 0) red_sum[part * 16 + r] = sum[u];
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt)
          *reinterpret_cast<float2*>(red_o + (part * 16 + r) * kDenseRedLd +
                                     8 * dt + 2 * tq) =
              make_float2(o_[dt][2 * u], o_[dt][2 * u + 1]);
      }
      // the next window's mask into lg, behind the rest of this one
      if (o + 1 < o1) load_mask(o + 1);
      group_sync();                              // the group's partials
      // out = (the warps' o) / (their sums), each added in warp order and
      // rounded once; the rows' maximum and sum
      for (int p = gt; p < 16 * 16; p += kDenseSplit * 32) {
        const int r = p >> 4, d = 2 * (p & 15), i = i0 + r;
        if (i >= n || d >= hd) continue;
        float sm = 0.f, o0 = 0.f, o1 = 0.f, mx = -CUDART_INF_F;
#pragma unroll
        for (int w = 0; w < kDenseSplit; ++w) {
          sm += red_sum[w * 16 + r];
          mx = fmaxf(mx, red_max[w * 16 + r]);
          const float2 x = *reinterpret_cast<const float2*>(
              red_o + (w * 16 + r) * kDenseRedLd + d);
          o0 += x.x;
          o1 += x.y;
        }
        *reinterpret_cast<unsigned*>(out + ((size_t)b * n + i) * c + h * hd +
                                     d) = pack_bf16(o0 / sm, o1 / sm);
        if (ms != nullptr && d == 0) {
          float* mp = ms + ((size_t)b * n + i) * 2 * nh + 2 * h;
          mp[0] = mx;
          mp[1] = sm;
        }
      }
    }
    __syncthreads();              // V, this K buffer and the partials read
    if (o + 1 < o1) load_kv(Vs, v, window(o + 1));
    cp_async_commit();
  }
}

// --------------------------------------------------- bfloat16 backward

// Shared memory of the backward, in bytes from its start: K, V (keys,
// kLdB), the q and g strips double-buffered, each warp's bfloat16(dl) tile
// (32 keys, 16 rows + 8), the rows' m and s double-buffered, the warps' rs
// parts and float32 dq tiles, the strips' rows, the strip's mask rows (16,
// ldw), then the dense bias rows (16, ldw), or the compact spans as copied,
// the shift-free spans and the strip's float32 dl (16, ldl).  The compact
// form double-buffers the mask rows and the shift-free spans.
constexpr int kLdDl = 24;       // a dl tile's row stride: 48 bytes
constexpr int kDlTile = kBwdKeys * kLdDl;

struct BwdBf16Layout {
  int warps, keys, ldw, ldl, span, slot, nbuf;
  size_t vs, qs, gs, dlt, ms, rs, tiles, rowtab, ws, bs, raw, spans, dls,
      total;
  __host__ __device__ BwdBf16Layout(int n, int compact, int wd, int hw,
                                    bool with_mask) {
    const Strips sp{n, wd, hw, compact ? 16 / wd : 0};
    warps = bwd_warps(n);
    keys = warps * kBwdKeys;
    ldw = ld4mod16(run_floats(keys));   // the warps' keys past n too
    ldl = keys + 4;
    // lanes tq read slots 2 tq, frames 2 tq: span = 4 (mod 32) puts them
    // 8 banks apart, the 8 keys gq beside each other
    span = compact ? sp.ips * hw + ((4 - sp.ips * hw) % 32 + 32) % 32 : 0;
    slot = compact ? run_floats(sp.ips * hw) : 0;
    nbuf = compact ? 2 : 1;
    vs = (size_t)keys * kLdB * 2;
    qs = 2 * vs;
    gs = qs + 2 * 16 * kLdB * 2;
    dlt = gs + 2 * 16 * kLdB * 2;
    ms = dlt + (size_t)warps * kDlTile * 2;
    rs = ms + 2 * 16 * 2 * 4;
    tiles = rs + (size_t)kBwdMaxWarps * 16 * 4;
    rowtab = tiles + (size_t)kBwdMaxWarps * 16 * 32 * 4;
    ws = align16(rowtab + (size_t)16 * sp.count() * 4);
    bs = ws + (with_mask ? (size_t)nbuf * 16 * ldw * 4 : 0);
    if (compact) {
      raw = bs;
      spans = raw + (size_t)(2 * wd - 1) * slot * 4;
      dls = align16(spans + (size_t)2 * (2 * wd - 1) * span * 4);
      total = dls + (size_t)16 * ldl * 4;
    } else {
      raw = spans = dls = bs + (size_t)16 * ldw * 4;
      total = dls;
    }
  }
};

template <bool kTap, bool kCompact>
__global__ void __launch_bounds__(kBwdMaxThreads, 1)
attn_bwd_bf16_kernel(const InRowsB q, const InRowsB k, const InRowsB v,
                     const InRowsB g, const float* __restrict__ bias,
                     const float* __restrict__ mask,
                     const float* __restrict__ ms, const OutRowsB dq,
                     const OutRowsB dk, const OutRowsB dv,
                     float* __restrict__ dl_out, float* __restrict__ dpart,
                     float* __restrict__ kv_part, bf16* __restrict__ e_tap,
                     int n, int nh, int hd, int nw, int wd, int hw,
                     float scale) {
  static_assert(kBwdKeys == 32, "a warp's keys are two k16 steps");
  extern __shared__ __align__(16) unsigned char attn_bwd_smem_bf16[];
  const BwdBf16Layout L(n, kCompact, wd, hw, mask != nullptr);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;     // mma's g and t
  const int ql = lane >> 3, rl = lane & 7;     // ldmatrix's matrix and row
  unsigned char* sm = attn_bwd_smem_bf16;
  bf16* Ks = reinterpret_cast<bf16*>(sm);                 // (keys, kLdB)
  bf16* Vs = reinterpret_cast<bf16*>(sm + L.vs);          // (keys, kLdB)
  bf16* Qs = reinterpret_cast<bf16*>(sm + L.qs);          // (2, 16, kLdB)
  bf16* Gs = reinterpret_cast<bf16*>(sm + L.gs);          // (2, 16, kLdB)
  bf16* dlt = reinterpret_cast<bf16*>(sm + L.dlt) + warp * kDlTile;
  float* Ms = reinterpret_cast<float*>(sm + L.ms);        // (2, 16, 2)
  float* rs_part = reinterpret_cast<float*>(sm + L.rs);   // (warps, 16)
  float* tiles = reinterpret_cast<float*>(sm + L.tiles);  // (warps, 16 * 32)
  int* rowtab = reinterpret_cast<int*>(sm + L.rowtab);    // (strips, 16)
  float* Ws = reinterpret_cast<float*>(sm + L.ws);        // (nbuf, 16, ldw)
  float* Bs = reinterpret_cast<float*>(sm + L.bs);        // (16, ldw)
  float* raw = reinterpret_cast<float*>(sm + L.raw);      // (2wd-1, slot)
  float* spans = reinterpret_cast<float*>(sm + L.spans);  // (2, 2wd-1, span)
  float* DLs = reinterpret_cast<float*>(sm + L.dls);      // (16, ldl)
  float* tile = tiles + warp * 16 * 32;
  const Strips sp{n, wd, hw, kCompact ? 16 / wd : 0};
  const int strips = sp.count();
  const int a_dim = 2 * wd - 1;
  const int warps = L.warps;
  const float* __restrict__ bias_h =
      bias + (size_t)h * (kCompact ? a_dim * hw * hw : n * n);
  const float* __restrict__ mask_b =
      mask != nullptr ? mask + (size_t)(b % nw) * n * n : nullptr;

  auto load_strip = [&](int buf, int s) {
    const int* rows = rowtab + 16 * s;
    load_strip_rows(Qs + buf * 16 * kLdB, q, b, h, rows, hd, tid, nthreads);
    load_strip_rows(Gs + buf * 16 * kLdB, g, b, h, rows, hd, tid, nthreads);
    for (int t = tid; t < 16; t += nthreads) {
      const int i = rows[t];
      cp_async<8>(Ms + (buf * 16 + t) * 2,
                  i >= 0 ? ms + ((size_t)b * n + i) * 2 * nh + 2 * h : ms,
                  i >= 0);
    }
  };
  // strip s's mask rows into Ws buffer buf, and its compact spans (raw) or
  // dense bias rows
  auto load_bias = [&](int s, int buf) {
    const int* rows = rowtab + 16 * s;
    if (mask_b != nullptr)
      stage_rows(Ws + buf * 16 * L.ldw, L.ldw, mask_b, rows, n, 0, n, warp,
                 warps, lane);
    if (kCompact) {
      const int ii0 = s * sp.ips;
      stage_spans(raw, L.slot, bias_h, wd, hw, ii0, min(sp.ips, hw - ii0),
                  warp, warps, lane);
    } else {
      stage_rows(Bs, L.ldw, bias_h, rows, n, 0, n, warp, warps, lane);
    }
  };
  auto align_bias = [&](int s, int buf) {
    if (kCompact) {
      const int ii0 = s * sp.ips;
      align_spans(spans + buf * a_dim * L.span, L.span, raw, L.slot, bias_h,
                  wd, hw, ii0, min(sp.ips, hw - ii0), warp, warps, lane);
    }
  };
  const int z = blockIdx.z, zs = gridDim.z;
  load_rows_bf16(Ks, k, b, h, 0, L.keys, n, hd, tid, nthreads);
  load_rows_bf16(Vs, v, b, h, 0, L.keys, n, hd, tid, nthreads);
  fill_rowtab(rowtab, sp, tid, nthreads);
  // the rs parts and dq shares of warps the block does not have: zeros,
  // so that the sums run over kBwdMaxWarps slots without a test
  for (int idx = warps * 16 + tid; idx < kBwdMaxWarps * 16; idx += nthreads)
    rs_part[idx] = 0.f;
  for (int idx = warps * 512 + tid; idx < kBwdMaxWarps * 512;
       idx += nthreads)
    tiles[idx] = 0.f;
  __syncthreads();                             // rowtab
  if (z < strips) {
    load_strip(0, z);
    load_bias(z, 0);
  }
  cp_async_commit();
  cp_async_wait_all();
  if (z < strips) align_bias(z, 0);
  __syncthreads();

  const int kb = warp * kBwdKeys;              // the warp's first key
  // the lane's keys kb + 16 mt + 8 hh + gq and slots 8 nt + 2 tq + u: the
  // compact bias's places K(j) and R(t), or the key clamped to n - 1
  int kpl[2][2], rsp[2][2], kvalid = 0;
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
    for (int i3 = 0; i3 < 2; ++i3) {
      const int j = kb + 16 * i2 + 8 * i3 + gq;
      kpl[i2][i3] = kCompact ? span_key(j, n, hw, L.span) : min(j, n - 1);
      kvalid |= (j < n) << (2 * i2 + i3);
      rsp[i2][i3] =
          kCompact ? span_row(8 * i2 + 2 * tq + i3, wd, hw, sp.ips, L.span)
                   : 0;
    }
  float* __restrict__ dl_b =
      dl_out != nullptr ? dl_out + ((size_t)b * nh + h) * n * n : nullptr;
  bf16* __restrict__ dqb = dq.at(b, h);

  // dk and dv of the warp's keys, (16 keys, 8 channels) tiles
  float dka[2][kDT][4], dva[2][kDT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[mt][dn][e] = dva[mt][dn][e] = 0.f;

  // strip ps's dq (the warps' shares added in warp order, times scale,
  // rounded) and, with the compact bias, its part of the (window, head)'s
  // compact dbias: run after the next strip's logits, before its first
  // barrier, which the next writes of the tiles and of DLs wait behind
  auto finish = [&](int ps) {
    if (ps < 0) return;
    const int* rows = rowtab + 16 * ps;
    const int s = ps;
    for (int idx = tid; idx < 16 * 32; idx += nthreads) {
      const int r = idx >> 5, cc = (idx & 31) ^ tile_swizzle(r);
      const int i = rows[r];
      if (i < 0 || cc >= hd) continue;
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdMaxWarps; ++w) x += tiles[w * 16 * 32 + idx];
      dqb[(long long)i * dq.sr + cc] = __float2bfloat16_rn(x * scale);
    }
    if (kCompact) {
      // the strip's part of the (window, head)'s compact dbias: for each
      // (a, ii, jj) its frame pairs d1 - d2 = a - wd + 1 added in d1
      // order; a warp a (a, ii) row, its lanes the columns jj
      const int ii0 = s * sp.ips, nrows = min(sp.ips, hw - ii0);
      float* dp_b = dpart + ((size_t)b * nh + h) * a_dim * hw * hw;
      for (int p = warp; p < a_dim * nrows; p += warps) {
        const int a = p / nrows, di = p - a * nrows, off = a - (wd - 1);
        const int d1a = max(0, off), terms = min(wd, wd + off) - d1a;
        const int step = L.ldl + hw;
        const float* src = DLs + (di * wd + d1a) * L.ldl + (d1a - off) * hw;
        float* dst = dp_b + ((size_t)a * hw + ii0 + di) * hw;
        for (int jj = lane; jj < hw; jj += 32) {
          float acc = src[jj];
#pragma unroll 1
          for (int d = 1; d < terms; ++d) acc += src[d * step + jj];
          dst[jj] = acc;
        }
      }
    }
  };

  int buf = 0, prev = -1;
  for (int s = z; s < strips; s += zs, buf ^= 1) {
    const bool next = s + zs < strips;
    const int wbuf = kCompact ? buf : 0;       // this strip's mask rows
    if (next) {
      load_strip(buf ^ 1, s + zs);
      // with two buffers the next strip's bias and mask come in now
      if (kCompact) load_bias(s + zs, buf ^ 1);
    }
    cp_async_commit();
    const bf16* Qb = Qs + buf * 16 * kLdB;
    const bf16* Gb = Gs + buf * 16 * kLdB;
    const float* Mb = Ms + buf * 16 * 2;
    const float* Wb = Ws + wbuf * 16 * L.ldw;
    const float* Sb = spans + buf * a_dim * L.span;
    const int* rows = rowtab + 16 * s;
    // the lane's slots 8 nt + 2 tq + u: 1 / s (0 where the slot holds no
    // row)
    float inv[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = 8 * nt + 2 * tq + u;
        inv[nt][u] = rows[t] >= 0 ? __frcp_rn(Mb[2 * t + 1]) : 0.f;
      }

    // s^T = K q^T and dp^T = V g^T on the warp's keys, (16 keys, 8 rows)
    // tiles over two k16 steps of channels: A from K or V (k-minor), B the
    // strip's q or g rows (k-minor, two 8-row tiles an ldmatrix)
    float st[2][2][4], dpt[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[mt][nt][e] = dpt[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      unsigned qb[4], gb[4];
      ldsm_x4(qb, Qb + (rl + 8 * (ql >> 1)) * kLdB + 16 * ks + 8 * (ql & 1));
      ldsm_x4(gb, Gb + (rl + 8 * (ql >> 1)) * kLdB + 16 * ks + 8 * (ql & 1));
      const unsigned q0[2] = {qb[0], qb[1]}, q1[2] = {qb[2], qb[3]};
      const unsigned g0[2] = {gb[0], gb[1]}, g1[2] = {gb[2], gb[3]};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        unsigned ka[4], va[4];
        const int at = (kb + 16 * mt + rl + 8 * (ql & 1)) * kLdB + 16 * ks +
                       8 * (ql >> 1);
        ldsm_x4(ka, Ks + at);
        ldsm_x4(va, Vs + at);
        mma_bf16(st[mt][0], ka, q0);
        mma_bf16(st[mt][1], ka, q1);
        mma_bf16(dpt[mt][0], va, g0);
        mma_bf16(dpt[mt][1], va, g1);
      }
    }

    // e = exp(l - m) in place of s, and the warp's part of rowsum(dp * e).
    // Element e of a tile: key kb + 16 mt + 8 (e >> 1) + gq, slot
    // 8 nt + 2 tq + (e & 1)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 8 * nt + 2 * tq + u, i = rows[r], rr = read_row(i);
        const bool rok = i >= 0;
        const float* wrow =
            mask_b != nullptr
                ? Wb + r * L.ldw + float_shift(mask_b + (size_t)rr * n)
                : nullptr;
        const float* brow =
            kCompact ? Sb + rsp[nt][u]
                     : Bs + r * L.ldw + float_shift(bias_h + (size_t)rr * n);
        const float rmax = Mb[2 * r];
        float acc = 0.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int e = 2 * hh + u, j = kb + 16 * mt + 8 * hh + gq;
            float l = fmaf(st[mt][nt][e], scale, brow[kpl[mt][hh]]);
            if (mask_b != nullptr) l += wrow[j];
            const float x = rok && (kvalid >> (2 * mt + hh) & 1)
                                ? __expf(l - rmax)
                                : 0.f;
            st[mt][nt][e] = x;
            acc = fmaf(dpt[mt][nt][e], x, acc);
            if (kTap && rok && j < n)
              e_tap[(((size_t)b * nh + h) * n + i) * n + j] =
                  __float2bfloat16_rn(x);
          }
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        acc += __shfl_xor_sync(0xffffffffu, acc, 8);
        acc += __shfl_xor_sync(0xffffffffu, acc, 16);
        if (gq == 0) rs_part[warp * 16 + r] = acc;
      }
    finish(prev);
    __syncthreads();
    // with one buffer the next strip's bias and mask come in now
    if (!kCompact && next) load_bias(s + zs, 0);
    cp_async_commit();

    // rs = (the warps' parts in warp order) * inv; dl = e (dp - rs) inv,
    // to the strip's dl rows (compact) or the scratch (dense, or a tap)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 8 * nt + 2 * tq + u, i = rows[r];
        float rs = 0.f;
#pragma unroll
        for (int w = 0; w < kBwdMaxWarps; ++w) rs += rs_part[w * 16 + r];
        // rounded where the reference rounds: rs, dp - rs, then the two
        // products (no contraction into an fma)
        rs = __fmul_rn(rs, inv[nt][u]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int e = 2 * hh + u, j = kb + 16 * mt + 8 * hh + gq;
            const float dl = __fmul_rn(
                __fmul_rn(st[mt][nt][e], __fsub_rn(dpt[mt][nt][e], rs)),
                inv[nt][u]);
            dpt[mt][nt][e] = dl;
            if (kCompact) DLs[r * L.ldl + j] = dl;
            // the dense form's dl is read once, by the windows' sum:
            // stored evict-first; a compact tap's as before (__stcs in the
            // compact instance, even where it never runs, slowed it 5%)
            if (dl_b != nullptr && i >= 0 && j < n) {
              if (kCompact)
                dl_b[i * n + j] = dl;
              else
                __stcs(dl_b + i * n + j, dl);
            }
          }
      }

    // dv += bfloat16(e)^T gs and dk += bfloat16(dl)^T q over the strip's 16
    // rows, one k16 step: the two 8-row tiles rounded in pairs are the A
    // fragment; B is gs or q (rows the contraction: ldmatrix.trans), gs =
    // bfloat16(g / s) formed in the B fragments of g (register r holds
    // slots 2 tq, 2 tq + 1, plus 8 where r is odd)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const unsigned ea[4] = {pack_bf16(st[mt][0][0], st[mt][0][1]),
                              pack_bf16(st[mt][0][2], st[mt][0][3]),
                              pack_bf16(st[mt][1][0], st[mt][1][1]),
                              pack_bf16(st[mt][1][2], st[mt][1][3])};
      const unsigned la[4] = {pack_bf16(dpt[mt][0][0], dpt[mt][0][1]),
                              pack_bf16(dpt[mt][0][2], dpt[mt][0][3]),
                              pack_bf16(dpt[mt][1][0], dpt[mt][1][1]),
                              pack_bf16(dpt[mt][1][2], dpt[mt][1][3])};
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        const int at = (rl + 8 * (ql & 1)) * kLdB + 16 * dp + 8 * (ql >> 1);
        unsigned gsb[4], qbt[4];
        ldsm_x4_trans(gsb, Gb + at);
        ldsm_x4_trans(qbt, Qb + at);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          gsb[r] = pack_bf16(bf16_lo(gsb[r]) * inv[r & 1][0],
                             bf16_hi(gsb[r]) * inv[r & 1][1]);
        const unsigned s0[2] = {gsb[0], gsb[1]}, s1[2] = {gsb[2], gsb[3]};
        const unsigned t0[2] = {qbt[0], qbt[1]}, t1[2] = {qbt[2], qbt[3]};
        mma_bf16(dva[mt][2 * dp], ea, s0);
        mma_bf16(dva[mt][2 * dp + 1], ea, s1);
        mma_bf16(dka[mt][2 * dp], la, t0);
        mma_bf16(dka[mt][2 * dp + 1], la, t1);
      }
      // bfloat16(dl) into the warp's tile, [key][slot]: lane's pairs of
      // slots 2 tq, 2 tq + 1 at keys 16 mt + gq and + 8
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        *reinterpret_cast<unsigned*>(dlt + (16 * mt + gq) * kLdDl + 8 * nt +
                                     2 * tq) = la[2 * nt];
        *reinterpret_cast<unsigned*>(dlt + (16 * mt + gq + 8) * kLdDl +
                                     8 * nt + 2 * tq) = la[2 * nt + 1];
      }
    }
    __syncwarp();

    // the warp's share of dq = bfloat16(dl) K over its 32 keys, two k16
    // steps: A from the dl tile (keys the contraction: ldmatrix.trans), B
    // from K's rows kb .. (keys the contraction: ldmatrix.trans)
    float dqa[kDT][4];
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[dn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      unsigned da[4];
      ldsm_x4_trans(da, dlt + (16 * kk + rl + 8 * (ql >> 1)) * kLdDl +
                            8 * (ql & 1));
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        unsigned kbt[4];
        ldsm_x4_trans(kbt, Ks + (kb + 16 * kk + rl + 8 * (ql & 1)) * kLdB +
                               16 * dp + 8 * (ql >> 1));
        const unsigned b0[2] = {kbt[0], kbt[1]}, b1[2] = {kbt[2], kbt[3]};
        mma_bf16(dqa[2 * dp], da, b0);
        mma_bf16(dqa[2 * dp + 1], da, b1);
      }
    }
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn) {
      *reinterpret_cast<float2*>(tile + tile_at(gq, 8 * dn + 2 * tq)) =
          make_float2(dqa[dn][0], dqa[dn][1]);
      *reinterpret_cast<float2*>(tile + tile_at(gq + 8, 8 * dn + 2 * tq)) =
          make_float2(dqa[dn][2], dqa[dn][3]);
    }
    cp_async_wait_all();     // the next strip and its rows have landed
    if (next) align_bias(s + zs, buf ^ 1);
    __syncthreads();

    prev = s;
  }
  finish(prev);

  // dk and dv of the warp's keys: element e of tile (mt, dn) is key
  // kb + 16 mt + gq + 8 (e >> 1), channels 8 dn + 2 tq and + 1
  const long long per = (long long)gridDim.y * nh * n * hd;
  float* dkp = kv_part != nullptr
                   ? kv_part + z * per + ((long long)b * nh + h) * n * hd
                   : nullptr;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = kb + 16 * mt + gq + 8 * hh;
        const int d = 8 * dn + 2 * tq;
        if (j >= n || d >= hd) continue;
        const float k0 = dka[mt][dn][2 * hh], k1 = dka[mt][dn][2 * hh + 1];
        const float v0 = dva[mt][dn][2 * hh], v1 = dva[mt][dn][2 * hh + 1];
        if (dkp != nullptr) {
          dkp[j * hd + d] = k0, dkp[j * hd + d + 1] = k1;
          dkp[zs * per + j * hd + d] = v0, dkp[zs * per + j * hd + d + 1] = v1;
        } else {
          *reinterpret_cast<unsigned*>(dk.at(b, h) + (long long)j * dk.sr +
                                       d) = pack_bf16(k0 * scale, k1 * scale);
          *reinterpret_cast<unsigned*>(dv.at(b, h) + (long long)j * dv.sr +
                                       d) = pack_bf16(v0, v1);
        }
      }
}

// dbias (nh, 2wd-1, hw, hw) from the (window, head) partials (b_, nh,
// 2wd-1, hw, hw): the windows added in their order, from 0, as vitta_tpu's
// grid adds them into its zeroed dbias (pallas_attention.py:517-527).
__global__ void __launch_bounds__(256)
dbias_windows_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                     int b_, long long per) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= per) return;
  float acc = 0.f;
  for (int b = 0; b < b_; ++b) acc += part[b * per + idx];
  dbias[idx] = acc;
}

// 16-byte units of q, k, v, g and their gradients: pointers and strides
// multiples of 8 values, hd a multiple of 8.
template <class T>
inline bool rows_aligned_bf16(const Rows<T>& x) {
  return (reinterpret_cast<std::uintptr_t>(x.p) & 15) == 0 && x.sb % 8 == 0 &&
         x.sr % 8 == 0 && x.sh % 8 == 0;
}

// The shapes the bfloat16 kernels take beyond the float32 ones: hd a
// multiple of 8, a compact window at most kMaxWd frames deep.
inline bool bad_dims_bf16(int b_, int n, int nh, int hd, int nw,
                          bool with_mask, int compact, int wd, int hw) {
  return bad_dims(b_, n, nh, hd, nw, with_mask, compact, wd, hw) ||
         hd % 8 != 0 || (compact && wd > kMaxWd);
}

// Tokens of x at most kMaxRowStride values apart.
template <class T>
inline bool near_rows(const Rows<T>& x) {
  return x.sr <= kMaxRowStride;
}

// Groups of five warps a compact forward block: as many as fit shared
// memory, up to kFwdMaxGroups.
inline int fwd_bf16_groups(const FwdBf16Layout& L) {
  int groups = kFwdMaxGroups;
  while (groups > 1 && L.bytes(groups) > kSmemPerBlock) --groups;
  return groups;
}

// Above 48 KB of dynamic shared memory a kernel must ask for it.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

template <bool kTap>
inline cudaError_t launch_fwd_compact_bf16(const InRowsB& q, const InRowsB& k,
                                           const InRowsB& v, const float* bias,
                                           const float* mask, bf16* out,
                                           float* ms, bf16* e_tap, int b_,
                                           int n, int nh, int hd, int nw,
                                           int wd, int hw, float scale,
                                           cudaStream_t stream) {
  auto kernel = attn_fwd_bf16_kernel<kTap>;
  const FwdBf16Layout L(n, wd, hw, mask != nullptr);
  const int groups = fwd_bf16_groups(L);
  const size_t smem = L.bytes(groups);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(nh, b_, row_split(nh * b_));
  kernel<<<grid, groups * kFwdGroupThreads, smem, stream>>>(
      q, k, v, bias, mask, out, ms, e_tap, n, nh, hd, nw, wd, hw, scale);
  count_launch(kTap ? "attn_fwd_bf16_kernel<tap>" : "attn_fwd_bf16_kernel");
  return cudaGetLastError();
}

// The dense plan of a call whose bias and mask lie where they are given.
inline DenseFwdPlan dense_fwd_plan_of(const float* bias, const float* mask,
                                      int b_, int n, int nh, int nw) {
  const bool vec =
      n % 4 == 0 && (reinterpret_cast<std::uintptr_t>(bias) & 15) == 0 &&
      (reinterpret_cast<std::uintptr_t>(mask) & 15) == 0;
  return dense_fwd_plan(b_, n, nh, mask != nullptr ? nw : 0, vec,
                        sm_count());
}

template <bool kTap, bool kMask>
inline cudaError_t launch_fwd_dense_bf16(const InRowsB& q, const InRowsB& k,
                                         const InRowsB& v, const float* bias,
                                         const float* mask, bf16* out,
                                         float* ms, bf16* e_tap, int b_,
                                         int n, int nh, int hd, int nw,
                                         float scale, cudaStream_t stream) {
  auto kernel = attn_fwd_dense_bf16_kernel<kTap, kMask>;
  const DenseFwdPlan P = dense_fwd_plan_of(bias, mask, b_, n, nh, nw);
  cudaError_t e = allow_smem(kernel, P.smem);
  if (e != cudaSuccess) return e;
  kernel<<<P.blocks, P.slots * kDenseSplit * 32, P.smem, stream>>>(
      q, k, v, bias, mask, out, ms, e_tap, b_, n, nh, hd, nw, scale, P);
  count_launch(kTap ? "attn_fwd_dense_bf16_kernel<tap>"
                    : "attn_fwd_dense_bf16_kernel");
  return cudaGetLastError();
}

// The forward at bfloat16 on q, k, v where they lie (strided rows, each a
// multiple of 8 values apart and 16-byte aligned): out bfloat16 (b_, n,
// nh*hd); bias, mask, ms float32 as launch_fwd takes them.  One launch:
// the compact kernel on the compact bias, the dense kernel on the dense.
// cudaErrorMisalignedAddress where a row of q, k, v or out is not 16-byte
// aligned.  e_tap: nullptr, or (b_, nh, n, n) bfloat16 for bfloat16(e)
// (kTap).
inline cudaError_t launch_fwd_bf16(const InRowsB& q, const InRowsB& k,
                                   const InRowsB& v, const float* bias,
                                   const float* mask, bf16* out, float* ms,
                                   bf16* e_tap, int b_, int n, int nh, int hd,
                                   int nw, int compact, int wd, int hw,
                                   float scale, cudaStream_t stream) {
  if (bad_dims_bf16(b_, n, nh, hd, nw, mask != nullptr, compact, wd, hw) ||
      out == nullptr || !near_rows(q) || !near_rows(k) || !near_rows(v))
    return cudaErrorInvalidValue;
  if (!rows_aligned_bf16(q) || !rows_aligned_bf16(k) ||
      !rows_aligned_bf16(v) || (reinterpret_cast<std::uintptr_t>(out) & 15))
    return cudaErrorMisalignedAddress;
  const bool tap = e_tap != nullptr;
  if (compact) {
#define VITTA_FWD_BF16(T)                                                  \
  launch_fwd_compact_bf16<T>(q, k, v, bias, mask, out, ms, e_tap, b_, n, nh, \
                             hd, nw, wd, hw, scale, stream)
    return tap ? VITTA_FWD_BF16(true) : VITTA_FWD_BF16(false);
#undef VITTA_FWD_BF16
  }
#define VITTA_FWD_BF16(T, M)                                                \
  launch_fwd_dense_bf16<T, M>(q, k, v, bias, mask, out, ms, e_tap, b_, n, nh, \
                              hd, nw, scale, stream)
  if (mask != nullptr)
    return tap ? VITTA_FWD_BF16(true, true) : VITTA_FWD_BF16(false, true);
  return tap ? VITTA_FWD_BF16(true, false) : VITTA_FWD_BF16(false, false);
#undef VITTA_FWD_BF16
}

// The same on the packed qkv (b_, n, 3*nh*hd).
inline cudaError_t launch_packed_fwd_bf16(const bf16* qkv, const float* bias,
                                          const float* mask, bf16* out,
                                          float* ms, bf16* e_tap, int b_,
                                          int n, int nh, int hd, int nw,
                                          int compact, int wd, int hw,
                                          float scale, cudaStream_t stream) {
  return launch_fwd_bf16(packed_rows(qkv, 0, n, nh, hd),
                         packed_rows(qkv, 1, n, nh, hd),
                         packed_rows(qkv, 2, n, nh, hd), bias, mask, out, ms,
                         e_tap, b_, n, nh, hd, nw, compact, wd, hw, scale,
                         stream);
}

// Floats of scratch launch_packed_bwd_bf16 needs: dl (b_, nh, n, n) with
// the dense bias or a tap, the (window, head) partials (b_, nh, 2wd-1, hw,
// hw) with the compact bias, and the blocks' shares of dk and dv where
// blocks share a problem, in that order.
inline long long bwd_bf16_scratch_floats(int b_, int n, int nh, int hd,
                                         int compact, int wd, int hw,
                                         int tap) {
  const long long probs = (long long)b_ * nh;
  const int split = bwd_split(b_, nh);
  return (!compact || tap ? probs * n * n : 0) +
         (compact ? probs * (2 * wd - 1) * hw * hw : 0) +
         (split > 1 ? 2LL * split * probs * n * hd : 0);
}

// The backward at bfloat16 on q, k, v where they lie, g (b_, n, nh*hd)
// and dq, dk, dv (strided rows, as launch_fwd_bf16 takes them) bfloat16;
// bias, mask, ms, dbias, scratch float32 (bwd_bf16_scratch_floats, laid
// out as it says).  The kernel, the sum of the blocks' float32 shares of dk
// and dv where problems are shared, and dbias: the windows' compact
// partials added in window order (dbias_windows_kernel), or, with the dense
// bias, dl summed over the windows (launch_dense_dbias_reduce).  e_tap:
// nullptr, or (b_, nh, n, n) bfloat16 for bfloat16(e) (kTap), which also
// writes dl to the scratch's first b_ nh n^2 floats.
inline cudaError_t launch_bwd_bf16(
    const InRowsB& q, const InRowsB& k, const InRowsB& v, const bf16* g,
    const OutRowsB& dq, const OutRowsB& dk, const OutRowsB& dv,
    const float* bias, const float* mask, const float* ms, float* dbias,
    float* scratch, bf16* e_tap, int b_, int n, int nh, int hd, int nw,
    int compact, int wd, int hw, float scale, cudaStream_t stream) {
  const long long c = (long long)nh * hd;
  const InRowsB gr{g, n * c, c, hd};
  if (bad_dims_bf16(b_, n, nh, hd, nw, mask != nullptr, compact, wd, hw) ||
      ms == nullptr || dbias == nullptr || scratch == nullptr ||
      !near_rows(q) || !near_rows(k) || !near_rows(v) || !near_rows(gr) ||
      !near_rows(dq) || !near_rows(dk) || !near_rows(dv))
    return cudaErrorInvalidValue;
  if (!rows_aligned_bf16(q) || !rows_aligned_bf16(k) ||
      !rows_aligned_bf16(v) || !rows_aligned_bf16(gr) ||
      !rows_aligned_bf16(dq) || !rows_aligned_bf16(dk) ||
      !rows_aligned_bf16(dv))
    return cudaErrorMisalignedAddress;
  const bool tap = e_tap != nullptr;
  const long long probs = (long long)b_ * nh;
  float* dl = !compact || tap ? scratch : nullptr;
  float* part = compact ? scratch + (dl != nullptr ? probs * n * n : 0)
                        : nullptr;
  const int split = bwd_split(b_, nh);
  float* kvp = split > 1 ? scratch + (dl != nullptr ? probs * n * n : 0) +
                               (compact ? probs * (2 * wd - 1) * hw * hw : 0)
                         : nullptr;
  const BwdBf16Layout L(n, compact, wd, hw, mask != nullptr);
  auto kernel = compact ? (tap ? attn_bwd_bf16_kernel<true, true>
                               : attn_bwd_bf16_kernel<false, true>)
                        : (tap ? attn_bwd_bf16_kernel<true, false>
                               : attn_bwd_bf16_kernel<false, false>);
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(nh, b_, split);
  kernel<<<grid, L.warps * 32, L.total, stream>>>(
      q, k, v, gr, bias, mask, ms, dq, dk, dv, dl, part, kvp, e_tap, n, nh,
      hd, nw, wd, hw, scale);
  count_launch(tap ? "attn_bwd_bf16_kernel<tap>" : "attn_bwd_bf16_kernel");
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (kvp != nullptr) {
    const long long outs = 2LL * b_ * nh * n * hd;
    dkv_sum_kernel<bf16><<<(unsigned)((outs + 255) / 256), 256, 0,
                           stream>>>(kvp, dk, dv, split, b_, n, nh, hd,
                                     scale);
    count_launch("dkv_sum_kernel<__nv_bfloat16>");
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (compact) {
    const long long per = (long long)nh * (2 * wd - 1) * hw * hw;
    dbias_windows_kernel<<<(unsigned)((per + 255) / 256), 256, 0, stream>>>(
        part, dbias, b_, per);
    count_launch("dbias_windows_kernel");
  } else {
    return launch_dense_dbias_reduce(dl, dbias, b_, n, nh, stream);
  }
  return cudaGetLastError();
}

// The same on the packed qkv (b_, n, 3*nh*hd), dq, dk and dv written packed
// into dqkv, the layout of qkv.
inline cudaError_t launch_packed_bwd_bf16(
    const bf16* qkv, const float* bias, const float* mask, const float* ms,
    const bf16* g, bf16* dqkv, float* dbias, float* scratch, bf16* e_tap,
    int b_, int n, int nh, int hd, int nw, int compact, int wd, int hw,
    float scale, cudaStream_t stream) {
  return launch_bwd_bf16(
      packed_rows(qkv, 0, n, nh, hd), packed_rows(qkv, 1, n, nh, hd),
      packed_rows(qkv, 2, n, nh, hd), g, packed_rows(dqkv, 0, n, nh, hd),
      packed_rows(dqkv, 1, n, nh, hd), packed_rows(dqkv, 2, n, nh, hd), bias,
      mask, ms, dbias, scratch, e_tap, b_, n, nh, hd, nw, compact, wd, hw,
      scale, stream);
}

}  // namespace attn
}  // namespace vitta
