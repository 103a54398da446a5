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
// The forward's e is taken against the row's final maximum, which the
// float32 kernel's online softmax does not know until its last chunk, so
// the bfloat16 forward walks the keys twice: the maximum first, then e, its
// sum and e v (the logits computed twice by the same instructions, so the
// second pass sees the first's values).  Every operand of a product is read
// from shared memory by ldmatrix (k-minor) or ldmatrix.trans (k-major), or
// is an accumulator tile pair rounded to bfloat16 in registers (bf16.cuh).
// q, k, v, g and their gradients are moved in 16-byte units of 8 values:
// the C entries refuse rows that are not 16-byte aligned.
// The instances with kTap true also write bfloat16(e) of every (row, key)
// to e_tap (B_, nh, N, N), the value each product takes, and the backward
// writes dl to its scratch as always: a check reads both and holds each
// output to its plain version on the kernel's own rounded e and dl.  The
// model's path runs the kTap false instances.

using InRowsB = Rows<const bf16>;
using OutRowsB = Rows<bf16>;

// Row stride, in bfloat16 values, of K, V, q and g in shared memory: 40
// values (80 bytes) put the eight rows an ldmatrix reads in different banks.
constexpr int kLdB = kMaxHeadDim + 8;

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

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

// The logits of an (16 rows, 8 keys) accumulator tile sc of keys jt ..:
// element e is row i0 + gq + 8 (e >> 1), key jt + 2 tq + (e & 1); -inf past
// key n.  The same instructions in both passes of the forward.
__device__ __forceinline__ void logits_tile(
    float (&lg)[4], const float (&sc)[4], int jt, int n, int tq,
    const size_t (&roff)[2], const size_t (&moff)[2], const int* coff,
    const float* __restrict__ bias, const float* __restrict__ mask_b,
    float scale) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int u = e >> 1, j = jt + 2 * tq + (e & 1);
    const int jc = j < n ? j : n - 1;
    float l = fmaf(sc[e], scale, bias[roff[u] + coff[j]]);
    if (mask_b != nullptr) l += mask_b[moff[u] + jc];
    lg[e] = j < n ? l : -CUDART_INF_F;
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

// The forward at bfloat16: grid, block and the strips of attn_fwd_kernel;
// K and V (round16(n), kLdB) bfloat16, the bias's column offsets and the
// warps' q tiles in shared memory.
template <bool kTap>
__global__ void __launch_bounds__(kFwdThreads, kFwdWarps <= 8 ? 2 : 1)
attn_fwd_bf16_kernel(const InRowsB q, const InRowsB k, const InRowsB v,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask, bf16* __restrict__ out,
                     float* __restrict__ ms, bf16* __restrict__ e_tap, int n,
                     int nh, int hd, int nw, int compact, int wd, int hw,
                     float scale) {
  extern __shared__ __align__(16) unsigned char attn_smem_bf16[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;     // mma's g and t
  const int keys = round16(n);
  bf16* Ks = reinterpret_cast<bf16*>(attn_smem_bf16);   // (keys, kLdB)
  bf16* Vs = Ks + keys * kLdB;                           // (keys, kLdB)
  int* coff = reinterpret_cast<int*>(Vs + keys * kLdB);  // (keys)
  bf16* Qw = reinterpret_cast<bf16*>(coff + keys) + warp * 16 * kLdB;
  load_rows_bf16(Ks, k, b, h, 0, keys, n, hd, tid, kFwdThreads);
  load_rows_bf16(Vs, v, b, h, 0, keys, n, hd, tid, kFwdThreads);
  cp_async_commit();
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
    // the strip's q as A fragments, two k16 steps over the channels
    __syncwarp();
    load_rows_bf16(Qw, q, b, h, i0, 16, n, hd, lane, 32);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    unsigned qf[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldsm_x4(qf[ks], Qw + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLdB +
                          16 * ks + 8 * (lane >> 4));

    // pass 1: the rows' maxima over all keys
    float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F};
    for (int jt = 0; jt < n; jt += 8) {
      float sc[4], lg[4];
      qk_tile(sc, qf, Ks, jt, lane);
      logits_tile(lg, sc, jt, n, tq, roff, moff, coff, bias, mask_b, scale);
      mrow[0] = fmaxf(mrow[0], fmaxf(lg[0], lg[1]));
      mrow[1] = fmaxf(mrow[1], fmaxf(lg[2], lg[3]));
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mrow[u] = fmaxf(mrow[u], __shfl_xor_sync(0xffffffffu, mrow[u], 1));
      mrow[u] = fmaxf(mrow[u], __shfl_xor_sync(0xffffffffu, mrow[u], 2));
    }

    // pass 2: e = exp(l - m), its sum, and o += bfloat16(e) v over 16 keys
    // at a time: the two 8-key tiles of e are the A fragment as they lie
    float o[kDT][4];
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    float lsum[2] = {0.f, 0.f};
    for (int j0 = 0; j0 < n; j0 += 16) {
      float ex[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int jt = j0 + 8 * half;
        if (jt >= n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ex[half][e] = 0.f;
          continue;
        }
        float sc[4], lg[4];
        qk_tile(sc, qf, Ks, jt, lane);
        logits_tile(lg, sc, jt, n, tq, roff, moff, coff, bias, mask_b,
                    scale);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = jt + 2 * tq + (e & 1);
          const float x = j < n ? __expf(lg[e] - mrow[e >> 1]) : 0.f;
          ex[half][e] = x;
          lsum[e >> 1] += x;
          if (kTap && j < n && row[e >> 1] < n)
            e_tap[(((size_t)b * nh + h) * n + row[e >> 1]) * n + j] =
                __float2bfloat16_rn(x);
        }
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

    // the rows' sums over the four lanes; out = o / sum, rounded
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      lsum[u] += __shfl_xor_sync(0xffffffffu, lsum[u], 1);
      lsum[u] += __shfl_xor_sync(0xffffffffu, lsum[u], 2);
      if (row[u] >= n) continue;
      bf16* orow = out + ((size_t)b * n + row[u]) * c + h * hd;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const int d = 8 * dt + 2 * tq;
        if (d < hd)
          *reinterpret_cast<unsigned*>(orow + d) =
              pack_bf16(o[dt][2 * u] / lsum[u], o[dt][2 * u + 1] / lsum[u]);
      }
      if (ms != nullptr && tq == 0) {
        float* m = ms + ((size_t)b * n + row[u]) * 2 * nh + 2 * h;
        m[0] = mrow[u];
        m[1] = lsum[u];
      }
    }
  }
}

// The backward at bfloat16: grid, block, strips of 16 query rows and the
// warps' 32 keys of attn_bwd_kernel.  Shared memory: K, V (keys, kLdB), the
// q and g strips double-buffered and gs (16, kLdB) bfloat16; the rows' m
// and s, the warps' parts of rs, each warp's bfloat16(dl) tile (32 keys,
// 16 rows + 8) and float32 dq tile (16, 32), the strip's bias and mask rows.
constexpr int kLdDl = 24;       // a dl tile's row stride: 48 bytes
constexpr int kDlTile = kBwdKeys * kLdDl;

__host__ __device__ inline size_t bwd_bf16_smem_bytes(int n) {
  const size_t warps = bwd_warps(n);
  const size_t halves = 2 * warps * kBwdKeys * kLdB + 5 * 16 * kLdB +
                        warps * kDlTile;
  const size_t floats = 4 * 16 + warps * 16 + warps * 16 * 32 +
                        2 * 16 * (size_t)bwd_ldb(n);
  return halves * 2 + floats * 4;
}

template <bool kTap>
__global__ void __launch_bounds__(kBwdMaxThreads, 1)
attn_bwd_bf16_kernel(const InRowsB q, const InRowsB k, const InRowsB v,
                     const InRowsB g, const float* __restrict__ bias,
                     const float* __restrict__ mask,
                     const float* __restrict__ ms, const OutRowsB dq,
                     const OutRowsB dk, const OutRowsB dv,
                     float* __restrict__ dl_out, float* __restrict__ kv_part,
                     bf16* __restrict__ e_tap, int n, int nh, int hd, int nw,
                     int compact, int wd, int hw, float scale, int vec_rows) {
  static_assert(kBwdKeys == 32, "a warp's keys are two k16 steps");
  extern __shared__ __align__(16) unsigned char attn_bwd_smem_bf16[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x, warps = nthreads >> 5;
  const int ldb = bwd_ldb(n);
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;     // mma's g and t
  const int ql = lane >> 3, rl = lane & 7;     // ldmatrix's matrix and row
  const int keys = warps * kBwdKeys;
  bf16* Ks = reinterpret_cast<bf16*>(attn_bwd_smem_bf16);  // (keys, kLdB)
  bf16* Vs = Ks + keys * kLdB;                              // (keys, kLdB)
  bf16* Qs = Vs + keys * kLdB;                   // (2, 16, kLdB)
  bf16* Gs = Qs + 2 * 16 * kLdB;                 // (2, 16, kLdB)
  bf16* GSs = Gs + 2 * 16 * kLdB;                // (16, kLdB)
  bf16* dlt = GSs + 16 * kLdB + warp * kDlTile;  // the warp's (32, kLdDl)
  float* Ms = reinterpret_cast<float*>(GSs + 16 * kLdB + warps * kDlTile);
  float* rs_part = Ms + 4 * 16;                  // (warps, 16)
  float* tiles = rs_part + warps * 16;           // (warps, 16 * 32)
  float* Bs = tiles + warps * 16 * 32;           // (16, ldb)
  float* Ws = Bs + 16 * ldb;                     // (16, ldb)
  float* tile = tiles + warp * 16 * 32;
  const float* __restrict__ bias_h =
      bias + (size_t)h * (compact ? (2 * wd - 1) * hw * hw : n * n);
  const float* __restrict__ mask_b =
      mask != nullptr ? mask + (size_t)(b % nw) * n * n : nullptr;

  auto load_strip = [&](int buf, int i0) {
    load_rows_bf16(Qs + buf * 16 * kLdB, q, b, h, i0, 16, n, hd, tid,
                   nthreads);
    load_rows_bf16(Gs + buf * 16 * kLdB, g, b, h, i0, 16, n, hd, tid,
                   nthreads);
    for (int r = tid; r < 16; r += nthreads) {
      const bool ok = i0 + r < n;
      cp_async<8>(Ms + (buf * 16 + r) * 2,
                  ok ? ms + ((size_t)b * n + i0 + r) * 2 * nh + 2 * h : ms,
                  ok);
    }
  };
  auto load_bias = [&](int i0) {
    load_bias_rows(Bs, Ws, bias_h, mask_b, i0, 16, n, ldb, compact, wd, hw,
                   vec_rows, warp, warps, lane);
  };
  const int strips = (n + 15) / 16;
  const int z = blockIdx.z, zs = gridDim.z;
  load_rows_bf16(Ks, k, b, h, 0, keys, n, hd, tid, nthreads);
  load_rows_bf16(Vs, v, b, h, 0, keys, n, hd, tid, nthreads);
  if (mask_b == nullptr)
    for (int idx = tid; idx < 16 * ldb; idx += nthreads) Ws[idx] = 0.f;
  if (z < strips) {
    load_strip(0, z * 16);
    load_bias(z * 16);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int kb = warp * kBwdKeys;              // the warp's first key
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

  int buf = 0;
  for (int s = z; s < strips; s += zs, buf ^= 1) {
    const int i0 = s * 16;
    if (s + zs < strips) load_strip(buf ^ 1, (s + zs) * 16);
    cp_async_commit();
    const bf16* Qb = Qs + buf * 16 * kLdB;
    const bf16* Gb = Gs + buf * 16 * kLdB;
    const float* Mb = Ms + buf * 16 * 2;
    // gs = bfloat16(g / s) of the strip's rows (zeros past row n)
    for (int idx = tid; idx < 16 * kMaxHeadDim; idx += nthreads) {
      const int r = idx / kMaxHeadDim, c = idx % kMaxHeadDim;
      const float inv = i0 + r < n ? __frcp_rn(Mb[2 * r + 1]) : 0.f;
      GSs[r * kLdB + c] =
          __float2bfloat16_rn(__bfloat162float(Gb[r * kLdB + c]) * inv);
    }
    __syncthreads();

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
    // Element e of a tile: key kb + 16 mt + 8 (e >> 1) + gq, row
    // 8 nt + 2 tq + (e & 1)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 8 * nt + 2 * tq + u;
        const bool rok = i0 + r < n;
        const float rmax = Mb[2 * r];
        float acc = 0.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int e = 2 * hh + u, j = kb + 16 * mt + 8 * hh + gq;
            const float l =
                fmaf(st[mt][nt][e], scale, Bs[r * ldb + j]) + Ws[r * ldb + j];
            const float x = rok && j < n ? __expf(l - rmax) : 0.f;
            st[mt][nt][e] = x;
            acc = fmaf(dpt[mt][nt][e], x, acc);
            if (kTap && rok && j < n)
              e_tap[(((size_t)b * nh + h) * n + i0 + r) * n + j] =
                  __float2bfloat16_rn(x);
          }
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        acc += __shfl_xor_sync(0xffffffffu, acc, 8);
        acc += __shfl_xor_sync(0xffffffffu, acc, 16);
        if (gq == 0) rs_part[warp * 16 + r] = acc;
      }
    __syncthreads();
    if (s + zs < strips) load_bias((s + zs) * 16);
    cp_async_commit();

    // rs = (the warps' parts in warp order) * inv; dl = e (dp - rs) inv
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 8 * nt + 2 * tq + u, i = i0 + r;
        const float inv = i < n ? __frcp_rn(Mb[2 * r + 1]) : 0.f;
        float rs = 0.f;
        for (int w = 0; w < warps; ++w) rs += rs_part[w * 16 + r];
        rs *= inv;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int e = 2 * hh + u, j = kb + 16 * mt + 8 * hh + gq;
            const float dl = st[mt][nt][e] * (dpt[mt][nt][e] - rs) * inv;
            dpt[mt][nt][e] = dl;
            if (dl_b != nullptr && i < n && j < n) dl_b[i * n + j] = dl;
          }
      }

    // dv += bfloat16(e)^T gs and dk += bfloat16(dl)^T q over the strip's 16
    // rows, one k16 step: the two 8-row tiles rounded in pairs are the A
    // fragment; B is gs or q (rows the contraction: ldmatrix.trans)
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
        ldsm_x4_trans(gsb, GSs + at);
        ldsm_x4_trans(qbt, Qb + at);
        const unsigned s0[2] = {gsb[0], gsb[1]}, s1[2] = {gsb[2], gsb[3]};
        const unsigned t0[2] = {qbt[0], qbt[1]}, t1[2] = {qbt[2], qbt[3]};
        mma_bf16(dva[mt][2 * dp], ea, s0);
        mma_bf16(dva[mt][2 * dp + 1], ea, s1);
        mma_bf16(dka[mt][2 * dp], la, t0);
        mma_bf16(dka[mt][2 * dp + 1], la, t1);
      }
      // bfloat16(dl) into the warp's tile, [key][row]: lane's pairs of rows
      // 2 tq, 2 tq + 1 at keys 16 mt + gq and + 8
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
    __syncthreads();

    // the strip's dq: the warps' shares added in warp order, times scale,
    // rounded
    for (int idx = tid; idx < 16 * 32; idx += nthreads) {
      const int r = idx >> 5, c = (idx & 31) ^ tile_swizzle(r);
      float x = 0.f;
      for (int w = 0; w < warps; ++w) x += tiles[w * 16 * 32 + idx];
      if (i0 + r < n && c < hd)
        dqb[(long long)(i0 + r) * dq.sr + c] = __float2bfloat16_rn(x * scale);
    }
  }

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

inline size_t fwd_bf16_smem_bytes(int n) {
  return (size_t)round16(n) * (2 * kLdB * 2 + 4) + kFwdWarps * 16 * kLdB * 2;
}

// 16-byte units of q, k, v, g and their gradients: pointers and strides
// multiples of 8 values, hd a multiple of 8.
inline bool rows_aligned_bf16(const Rows<const bf16>& x) {
  return (reinterpret_cast<std::uintptr_t>(x.p) & 15) == 0 && x.sb % 8 == 0 &&
         x.sr % 8 == 0 && x.sh % 8 == 0;
}

// The packed forward at bfloat16: qkv, out bfloat16 (b_, n, 3*nh*hd) and
// (b_, n, nh*hd); bias, mask, ms float32 as launch_fwd takes them.  One
// launch.  cudaErrorMisalignedAddress where qkv or out is not 16-byte
// aligned.
template <bool kTap>
inline cudaError_t launch_fwd_bf16_instance(const InRowsB& q, const InRowsB& k,
                                            const InRowsB& v,
                                            const float* bias,
                                            const float* mask, bf16* out,
                                            float* ms, bf16* e_tap, int b_,
                                            int n, int nh, int hd, int nw,
                                            int compact, int wd, int hw,
                                            float scale, cudaStream_t stream) {
  const size_t smem = fwd_bf16_smem_bytes(n);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_bf16_kernel<kTap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_fwd_bf16_kernel<kTap>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(nh, b_, row_split(nh * b_));
  attn_fwd_bf16_kernel<kTap><<<grid, kFwdThreads, smem, stream>>>(
      q, k, v, bias, mask, out, ms, e_tap, n, nh, hd, nw, compact, wd, hw,
      scale);
  count_launch(kTap ? "attn_fwd_bf16_kernel<tap>" : "attn_fwd_bf16_kernel");
  return cudaGetLastError();
}

// e_tap: nullptr, or (b_, nh, n, n) bfloat16 for bfloat16(e) (kTap).
inline cudaError_t launch_packed_fwd_bf16(const bf16* qkv, const float* bias,
                                          const float* mask, bf16* out,
                                          float* ms, bf16* e_tap, int b_,
                                          int n, int nh, int hd, int nw,
                                          int compact, int wd, int hw,
                                          float scale, cudaStream_t stream) {
  if (bad_dims(b_, n, nh, hd, nw, mask != nullptr, compact, wd, hw) ||
      out == nullptr || hd % 8 != 0 ||
      3LL * nh * hd > kMaxRowStride)
    return cudaErrorInvalidValue;
  const InRowsB q = packed_rows(qkv, 0, n, nh, hd);
  const InRowsB k = packed_rows(qkv, 1, n, nh, hd);
  const InRowsB v = packed_rows(qkv, 2, n, nh, hd);
  if (!rows_aligned_bf16(q) || !rows_aligned_bf16(k) ||
      !rows_aligned_bf16(v) || (reinterpret_cast<std::uintptr_t>(out) & 15))
    return cudaErrorMisalignedAddress;
  return e_tap != nullptr
             ? launch_fwd_bf16_instance<true>(q, k, v, bias, mask, out, ms,
                                              e_tap, b_, n, nh, hd, nw,
                                              compact, wd, hw, scale, stream)
             : launch_fwd_bf16_instance<false>(q, k, v, bias, mask, out, ms,
                                               nullptr, b_, n, nh, hd, nw,
                                               compact, wd, hw, scale, stream);
}

// The packed backward at bfloat16: qkv, g, dqkv bfloat16; bias, mask, ms,
// dbias, scratch float32.  The kernel, the sum of the blocks' float32
// shares of dk and dv where problems are shared, and the sum of dl over the
// windows (dbias, float32).
// e_tap: nullptr, or (b_, nh, n, n) bfloat16 for bfloat16(e) (kTap); dl
// is the first b_ * nh * n * n floats of scratch, (b_, nh, n, n), where
// dbias is asked for.
inline cudaError_t launch_packed_bwd_bf16(
    const bf16* qkv, const float* bias, const float* mask, const float* ms,
    const bf16* g, bf16* dqkv, float* dbias, float* scratch, bf16* e_tap,
    int b_, int n, int nh, int hd, int nw, int compact, int wd, int hw,
    float scale, cudaStream_t stream) {
  if (bad_dims(b_, n, nh, hd, nw, mask != nullptr, compact, wd, hw) ||
      ms == nullptr || hd % 8 != 0 || 3LL * nh * hd > kMaxRowStride)
    return cudaErrorInvalidValue;
  const long long c = (long long)nh * hd;
  const InRowsB q = packed_rows(qkv, 0, n, nh, hd);
  const InRowsB k = packed_rows(qkv, 1, n, nh, hd);
  const InRowsB v = packed_rows(qkv, 2, n, nh, hd);
  const InRowsB gr{g, n * c, c, hd};
  const OutRowsB dq = packed_rows(dqkv, 0, n, nh, hd);
  const OutRowsB dk = packed_rows(dqkv, 1, n, nh, hd);
  const OutRowsB dv = packed_rows(dqkv, 2, n, nh, hd);
  if (!rows_aligned_bf16(q) || !rows_aligned_bf16(k) ||
      !rows_aligned_bf16(v) || !rows_aligned_bf16(gr) ||
      (reinterpret_cast<std::uintptr_t>(dqkv) & 15))
    return cudaErrorMisalignedAddress;
  const int vec_rows =
      n % 4 == 0 && (reinterpret_cast<std::uintptr_t>(bias) & 15) == 0 &&
      (reinterpret_cast<std::uintptr_t>(mask) & 15) == 0;
  const size_t smem = bwd_bf16_smem_bytes(n);
  auto kernel = e_tap != nullptr ? attn_bwd_bf16_kernel<true>
                                 : attn_bwd_bf16_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int split = bwd_split(b_, nh);
  float* part = split > 1 ? scratch + (size_t)b_ * nh * n * n : nullptr;
  const dim3 grid(nh, b_, split);
  kernel<<<grid, bwd_warps(n) * 32, smem, stream>>>(
      q, k, v, gr, bias, mask, ms, dq, dk, dv,
      dbias != nullptr ? scratch : nullptr, part, e_tap, n, nh, hd, nw,
      compact, wd, hw, scale, vec_rows);
  count_launch(e_tap != nullptr ? "attn_bwd_bf16_kernel<tap>"
                                : "attn_bwd_bf16_kernel");
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (part != nullptr) {
    const long long outs = 2LL * b_ * nh * n * hd;
    dkv_sum_kernel<bf16><<<(unsigned)((outs + 255) / 256), 256, 0,
                           stream>>>(part, dk, dv, split, b_, n, nh, hd,
                                     scale);
    count_launch("dkv_sum_kernel<__nv_bfloat16>");
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

}  // namespace attn
}  // namespace vitta
