// Row LayerNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vitta_tpu/ops/pallas_ln.py:
//   _fwd_kernel (:47, launched by _ln_fwd :81) and
//   _bwd_kernel (:55, launched by _ln_bwd :96).
//
// What it computes, per row of an (R, C) float32 matrix:
//   y = (x - mu) * rsqrt(E[x^2] - mu^2 + eps) * gamma + beta
// with the one-pass float32 statistics of the TPU kernel, and from
// (x, gamma, dy), with the statistics recomputed as the TPU kernel does:
//   dx, dgamma (C), dbeta (C)          (formulas in ln_rows.cuh)
//
// What bounds it: bytes.  A handful of operations per element against one
// read and one write of the activation, so the design (ln_rows.cuh) keeps a
// row in one warp's registers between the read and the write: 16-byte loads
// and stores, neighbouring lanes on neighbouring addresses, two shuffle
// reductions, no shared memory and no second pass over device memory.  The
// TPU kernel's row blocks (a power-of-two divisor of R) have no counterpart:
// any R is taken, eight rows to a block.  The backward is bound by bytes
// too (x and dy read, dx written); the TPU kernel adds dgamma and dbeta into
// one block that its sequential grid revisits, which a CUDA grid cannot:
// at float32 each block keeps its rows' column sums in registers as it
// makes dx, writes one partial, and a second launch adds the partials in
// block order, without atomics (ln_rows.cuh).
//
// At bfloat16 (vitta_tpu runs these kernels at the compute dtype: x, y, dy
// and dx bfloat16; gamma, beta, the statistics, every sum and dgamma and
// dbeta float32, pallas_ln.py:47-73) the same arithmetic takes bfloat16
// rows: y and dx are rounded once.  The bound halves with the bytes.  The
// forward (ln_rows.cuh: ln_fwd_bf16x8, one launch a call) takes every C %
// 8 == 0 up to 2048 on 16-byte aligned pointers in 16-byte units of 8
// values, gamma and beta loaded into registers while the rows load, the
// rows shared over one wave; its plan is vitta_ln_fwd_bf16_plan's.  The
// backward,
// where C % 8 == 0, C <= kLnB16MaxC and x, dy, dx and gamma are 16-byte
// aligned (every Video Swin site), is ln_bwd_bf16x8 below: one launch a
// call.  At the Swin-B sites a call moves 5-40 MB, 1.4-12 us at the card's
// rate, so a second launch, a grid of one block an SM and 8-byte loads
// each cost a large share of it.  Its design:
// - a row is LANES lanes (4 to 128; up to 32 within a warp, beyond that 2
//   or 4 warps exchanging their row sums through shared memory), each with
//   UNITS (1 to 3) 16-byte units of 8 values, units lane, lane + LANES, ...;
//   the block's 256 threads are 256 / LANES row groups, two blocks an SM;
// - a group issues the loads of its next row before the arithmetic of the
//   present one (rows kept packed as bfloat16 in registers, unpacked where
//   used; gamma staged in shared memory);
// - each lane keeps its columns' sums of dy * xh and dy over its group's
//   rows; the groups of a warp are added in a butterfly, then the warps (or
//   groups) in order through shared memory: the block's (2, C);
// - the grid is one wave of clusters of up to 8 blocks (ln_bwd_bf16_plan),
//   the rows shared evenly; a warp whose rows run out stops;
// - each block sends slice r of its 2C sums to the block of rank r
//   (st.async into its shared memory, counted on its mbarrier: no fence
//   waits on the rows' stores), which adds the cluster's slices in rank
//   order and writes them as the cluster's partial; then it draws a ticket
//   of its slice (tickets.cuh), and the block that draws a slice's last
//   ticket adds the clusters' partials of that slice in cluster order,
//   all their loads in flight at once, and writes dgamma / dbeta there.
//   The 8 slices are finished by 8 blocks at once.
// Elsewhere (C not a multiple of 8, a view off a 16-byte boundary, C above
// kLnB16MaxC) the float32 plan's kernel takes units of 4 (8 bytes) or
// single values, and the second launch (ln_rows.cuh: launch_ln_bwd).
// tools/ln_variants.py builds copies with other constants and times them
// (backward, and with --fwd the bfloat16 forward) in turns with another
// checkout's kernels.

#include "ln_rows.cuh"
#include "tickets.cuh"

namespace vitta {
namespace {

constexpr int kLnB16Threads = 256;     // a block: 8 warps
constexpr int kLnB16BlocksPerSm = 2;   // blocks an SM holds (caps registers),
                                       // and the grid aims at no more
constexpr int kLnB16MinSteps = 1;      // rows a row group takes at least
constexpr int kLnB16MaxCluster = 8;    // blocks of a cluster
constexpr int kLnB16MaxUnits = 3;      // 16-byte units a lane holds of a row
constexpr int kLnB16MinLanes = 4;      // lanes a row, at least
constexpr int kLnB16MaxLanes = 128;    // and at most (4 warps)
constexpr int kLnB16MaxC = 2048;
constexpr int kLnB16SumAhead = 32;     // partials the last block loads at once

__host__ __device__ inline long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// How ln_bwd_bf16x8 cuts (rows, c): `lanes` lanes a row, each holding
// `units` 16-byte units of it; a grid of `blocks` blocks (a multiple of
// csize; the last may have no rows) of `chunk` contiguous rows each,
// clusters of `csize` blocks.  All blocks fit in one wave: at most
// `resident` clusters of kLnB16MaxCluster (what the card holds of the
// instance at once) and kLnB16BlocksPerSm blocks an SM of `sms`, the rows
// shared evenly (a warp whose rows run out stops early); a block takes at
// least kLnB16MinSteps rows a row group.  units 0 where the kernel takes no
// such shape.
// ops/cuda_ln.py:ln_bwd_bf16_plan mirrors it.
struct LnB16Plan {
  int lanes, units, csize;
  long long chunk, blocks;
};

inline LnB16Plan ln_bwd_bf16_plan(long long rows, int c, int resident,
                                  int sms) {
  LnB16Plan q{0, 0, 1, 0, 0};
  if (rows <= 0 || c <= 0 || c % 8 != 0 || c > kLnB16MaxC) return q;
  const int n = c / 8;
  int lanes = kLnB16MinLanes;
  while (lanes < kLnB16MaxLanes && cdiv(n, lanes) > kLnB16MaxUnits)
    lanes *= 2;
  q.lanes = lanes;
  q.units = (int)cdiv(n, lanes);
  const long long groups = kLnB16Threads / lanes;
  const long long by_sm = (long long)kLnB16BlocksPerSm * sms;
  const long long by_cluster = (long long)resident * kLnB16MaxCluster;
  const long long wave = by_cluster < by_sm ? by_cluster : by_sm;
  q.chunk = cdiv(rows, wave);
  if (q.chunk < kLnB16MinSteps * groups) q.chunk = kLnB16MinSteps * groups;
  const long long nb = cdiv(rows, q.chunk);
  q.csize = kLnB16MaxCluster;
  while (q.csize > 1 && q.csize > nb) q.csize /= 2;
  q.blocks = cdiv(nb, q.csize) * q.csize;
  return q;
}

// Floats of the partials: (blocks / csize, 2, c).
inline long long ln_bf16_partial_floats(const LnB16Plan& q, int c) {
  return q.blocks / q.csize * 2LL * c;
}

// Shared memory of an instance at c: gamma (c), the owners' sums (owners,
// 2, c), the block's (2, c) and the slices the cluster's blocks send it
// (csize, 2c / csize, at most 2c).
template <int L>
__host__ __device__ constexpr int ln_bf16_owners() {
  return L < 32 ? kLnB16Threads / 32 : kLnB16Threads / L;
}
template <int L>
size_t ln_bf16_smem(int c) {
  return (size_t)(5 + 2 * ln_bf16_owners<L>()) * c * sizeof(float);
}

__device__ __forceinline__ void unpack8(uint4 u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = bf16_lo(w[j]);
    f[2 * j + 1] = bf16_hi(w[j]);
  }
}

// A row's units of x and dy as they lie in memory (zero where the row or
// the unit does not exist).
template <int U, int L>
__device__ __forceinline__ void load_row(const bf16* __restrict__ x,
                                         const bf16* __restrict__ dy,
                                         long long row, long long r1, int n,
                                         int sub, uint4 (&ox)[U],
                                         uint4 (&od)[U]) {
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = sub + L * i;
    ox[i] = od[i] = make_uint4(0u, 0u, 0u, 0u);
    if (row < r1 && u < n) {
      const long long at = (row * n + u) * 8;
      ox[i] = *reinterpret_cast<const uint4*>(x + at);
      od[i] = *reinterpret_cast<const uint4*>(dy + at);
    }
  }
}

// A row's two sums over its L lanes: a butterfly over the lanes of each
// warp, then (L > 32) the row's warps in order through `xch`.  Every thread
// of the block calls it at the same step.
template <int L>
__device__ __forceinline__ void row_sums(float& a, float& b,
                                         float2* __restrict__ xch) {
  constexpr int RL = L < 32 ? L : 32;
#pragma unroll
  for (int o = RL / 2; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if constexpr (L > 32) {
    constexpr int WPR = L / 32;
    const int warp = threadIdx.x >> 5, first = threadIdx.x / L * WPR;
    if ((threadIdx.x & 31) == 0) xch[warp] = make_float2(a, b);
    __syncthreads();
    float2 v = xch[first];
#pragma unroll
    for (int k = 1; k < WPR; ++k) {
      const float2 o = xch[first + k];
      v.x += o.x;
      v.y += o.y;
    }
    a = v.x;
    b = v.y;
  }
}

// grid (blocks), block kLnB16Threads, clusters of csize along x, dynamic
// shared memory ln_bf16_smem<L>(c).  Block b takes rows [b * chunk,
// min((b + 1) * chunk, rows)); row group g (threads g * L .. g * L + L - 1)
// takes at step s the row r0 + s * groups + g.  dgb (2, c): dgamma then
// dbeta; partial (blocks / csize, 2, c): each cluster's sums.
template <int U, int L>
__global__ void __launch_bounds__(kLnB16Threads, kLnB16BlocksPerSm)
ln_bwd_bf16x8(const bf16* __restrict__ x, const float* __restrict__ gamma,
              const bf16* __restrict__ dy, bf16* __restrict__ dx,
              float* __restrict__ dgb, float* __restrict__ partial,
              int slot, long long rows, int c, long long chunk, int csize,
              float eps) {
  constexpr int G = kLnB16Threads / L;          // row groups
  constexpr int OWN = ln_bf16_owners<L>();      // holders of a block's sums
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                              // gamma
  float* red = gs + c;                           // (OWN, 2, c)
  float* part = red + 2 * OWN * c;               // (2, c)
  float* recv = part + 2 * c;                    // (csize, slice)
  __shared__ float2 xch[2][kLnB16Threads / 32];
  __shared__ __align__(8) unsigned long long bar;
  __shared__ int last;
  const int tid = threadIdx.x, grp = tid / L, sub = tid % L;
  const int n = c >> 3;
  // the cluster's blocks send each other their sums with st.async, counted
  // on the receiver's mbarrier: made here, before the cluster's barrier
  if (csize > 1) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&bar))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_arrive_relaxed();
  }
  const long long r0 = (long long)blockIdx.x * chunk;
  const long long r1 = r0 + chunk < rows ? r0 + chunk : rows;
  const long long steps = r1 > r0 ? cdiv(r1 - r0, G) : 0;
  for (int i = tid; i < c; i += kLnB16Threads) gs[i] = gamma[i];
  uint4 cx[U], cd[U];
  load_row<U, L>(x, dy, r0 + grp, r1, n, sub, cx, cd);
  __syncthreads();
  float ag[U][8], ab[U][8];
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) ag[i][j] = ab[i][j] = 0.f;
  const float inv_c = 1.0f / c;
  for (long long s = 0; s < steps; ++s) {
    const long long r = r0 + s * G + grp;
    // a warp whose rows have run out stops (rows only grow with s); row
    // groups of several warps take every step, for the barriers
    if (L <= 32 && !__any_sync(0xffffffffu, r < r1)) break;
    uint4 nx[U], nd[U];                  // the next row loads meanwhile
    load_row<U, L>(x, dy, r + G, r1, n, sub, nx, nd);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      float v[8];
      unpack8(cx[i], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s1 += v[j];
        s2 += v[j] * v[j];
      }
    }
    row_sums<L>(s1, s2, xch[0]);
    const float mu = s1 * inv_c;
    const float rstd = rsqrtf(s2 * inv_c - mu * mu + eps);
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = sub + L * i;
      if (u < n) {
        float v[8], d[8];
        unpack8(cx[i], v);
        unpack8(cd[i], d);
        const float4 g0 = *reinterpret_cast<const float4*>(gs + 8 * u);
        const float4 g1 = *reinterpret_cast<const float4*>(gs + 8 * u + 4);
        const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = (v[j] - mu) * rstd, wg = d[j] * g[j];
          sa += wg;
          sb += wg * xh;
        }
      }
    }
    row_sums<L>(sa, sb, xch[1]);
    const float a = sa * inv_c, b = sb * inv_c;
    if (r < r1) {
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int u = sub + L * i;
        if (u < n) {
          float v[8], d[8], o[8];
          unpack8(cx[i], v);
          unpack8(cd[i], d);
          const float4 g0 = *reinterpret_cast<const float4*>(gs + 8 * u);
          const float4 g1 = *reinterpret_cast<const float4*>(gs + 8 * u + 4);
          const float g[8] = {g0.x, g0.y, g0.z, g0.w,
                              g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float xh = (v[j] - mu) * rstd;
            o[j] = rstd * (d[j] * g[j] - a - xh * b);
            ag[i][j] += d[j] * xh;
            ab[i][j] += d[j];
          }
          *reinterpret_cast<uint4*>(dx + (r * n + u) * 8) =
              make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                         pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      cx[i] = nx[i];
      cd[i] = nd[i];
    }
  }
  // the row groups of a warp added in a butterfly (offsets 16 .. L), then
  // the owners (warps, or groups of L > 32 lanes) in order: dgamma, dbeta
  if constexpr (L < 32) {
#pragma unroll
    for (int o = 16; o >= L; o >>= 1)
#pragma unroll
      for (int i = 0; i < U; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          ag[i][j] += __shfl_xor_sync(0xffffffffu, ag[i][j], o);
          ab[i][j] += __shfl_xor_sync(0xffffffffu, ab[i][j], o);
        }
  }
  const bool holds = L < 32 ? (tid & 31) < L : true;
  const int owner = L < 32 ? tid >> 5 : grp;
  if (holds)
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = sub + L * i;
      if (u < n)
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = pass == 0 ? ag[i][j] : ab[i][j];
          float* at = red + (2 * owner + pass) * c + 8 * u;
          *reinterpret_cast<float4*>(at) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(at + 4) =
              make_float4(v[4], v[5], v[6], v[7]);
        }
    }
  __syncthreads();
  for (int col = tid; col < 2 * c; col += kLnB16Threads) {
    float v = red[col];
#pragma unroll
    for (int k = 1; k < OWN; ++k) v += red[2 * k * c + col];
    part[col] = v;
  }
  __syncthreads();
  // the cluster's blocks in rank order, a slice of the 2c sums a block:
  // each block sends slice r of its sums to the block of rank r (st.async
  // into its `recv`, counted on its mbarrier: no fence waits on the rows'
  // stores), which adds them and writes the cluster's partial; then the
  // clusters in order, by the block that draws the slice's last ticket
  const unsigned rank = csize > 1 ? cluster_rank() : 0u;
  const int two_c = 2 * c;
  const int slice = (two_c + csize - 1) / csize;
  const int lo = (int)rank * slice;
  const int hi = lo + slice < two_c ? lo + slice : two_c;
  const long long q = blockIdx.x / csize, parts = gridDim.x / csize;
  float* mine = partial + q * two_c;
  if (csize > 1) {
    cluster_wait();                   // every block made its mbarrier
    const uint32_t bar_me = smem_addr(&bar);
    // 16 bytes a store where a slice is a multiple of 4 floats, else 8 (a
    // slice is c / 4 floats or more, c % 8 == 0)
    const int w = slice % 4 == 0 ? 4 : 2;
    for (int col = tid * w; col < two_c; col += kLnB16Threads * w) {
      const unsigned r = (unsigned)(col / slice);
      const int at = (int)rank * slice + col - (int)r * slice;
      if (r == rank) {
        for (int k = 0; k < w; ++k) recv[at + k] = part[col + k];
        continue;
      }
      uint32_t dst = smem_addr(recv + at), bar_r;
      asm volatile("mapa.shared::cluster.u32 %0, %0, %1;"
                   : "+r"(dst) : "r"(r));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(bar_r) : "r"(bar_me), "r"(r));
      if (w == 4) {
        const float4 v = *reinterpret_cast<const float4*>(part + col);
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
            "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(dst), "f"(v.x), "f"(v.y),
            "f"(v.z), "f"(v.w), "r"(bar_r)
            : "memory");
      } else {
        const float2 v = *reinterpret_cast<const float2*>(part + col);
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
            "[%0], {%1, %2}, [%3];" ::"r"(dst), "f"(v.x), "f"(v.y),
            "r"(bar_r)
            : "memory");
      }
    }
    if (tid == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                       "r"(bar_me), "r"((unsigned)((csize - 1) * (hi - lo) * 4))
                   : "memory");
    asm volatile(
        "{\n.reg .pred p;\nLN_WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
        "@!p bra LN_WAIT_%=;\n}" ::"r"(bar_me)
        : "memory");
    __syncthreads();                  // this block's own slice too
    for (int col = lo + tid; col < hi; col += kLnB16Threads) {
      float s = recv[col - lo];
      for (int k = 1; k < csize; ++k) s += recv[k * slice + col - lo];
      mine[col] = s;
    }
  } else {
    for (int col = tid; col < two_c; col += kLnB16Threads)
      mine[col] = part[col];
  }
  __syncthreads();
  if (tid == 0)
    last = draw_last_ticket(slot_tickets(slot) + rank, (unsigned)parts);
  __syncthreads();
  if (last) {
    for (int col = lo + tid; col < hi; col += kLnB16Threads) {
      const float* p = partial + col;
      float s = 0.f;
#pragma unroll 1
      for (long long p0 = 0; p0 < parts; p0 += kLnB16SumAhead) {
        float v[kLnB16SumAhead];
#pragma unroll
        for (int k = 0; k < kLnB16SumAhead; ++k)
          v[k] = p0 + k < parts ? __ldcg(p + (p0 + k) * two_c) : 0.f;
#pragma unroll
        for (int k = 0; k < kLnB16SumAhead; ++k)
          if (p0 + k < parts) s += v[k];
      }
      dgb[col] = s;
    }
  }
}

// One instance: its function, its shared memory at c, the clusters of
// kLnB16MaxCluster the card holds at its widest c (read once), its plan.
template <int U, int L>
struct LnB16Kernel {
  static const void* fn() { return (const void*)ln_bwd_bf16x8<U, L>; }
  // the attribute for its widest c's shared memory, once
  static cudaError_t allow_smem() {
    static const cudaError_t e = cudaFuncSetAttribute(
        ln_bwd_bf16x8<U, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)ln_bf16_smem<L>(8 * L * U));
    return e;
  }
  static int resident() {
    static const int n = [] {
      allow_smem();
      const size_t smem = ln_bf16_smem<L>(8 * L * U);
      return query_resident(fn(), dim3(kLnB16Threads), kLnB16MaxCluster, smem,
                            kLnB16BlocksPerSm);
    }();
    return n;
  }
};

template <int U, int L>
cudaError_t ln_bf16_launch(const LnB16Plan& q, const bf16* x,
                           const float* gamma, const bf16* dy, bf16* dx,
                           float* dgb, float* scratch, int slot,
                           long long rows, int c, float eps,
                           cudaStream_t st) {
  const cudaError_t allowed = LnB16Kernel<U, L>::allow_smem();
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)q.blocks);
  cfg.blockDim = dim3(kLnB16Threads);
  cfg.dynamicSmemBytes = ln_bf16_smem<L>(c);
  cfg.stream = st;
  cudaLaunchAttribute attr = cluster_attr(q.csize);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, ln_bwd_bf16x8<U, L>, x, gamma, dy, dx, dgb,
                         scratch, slot, rows, c, q.chunk, q.csize, eps);
  static const std::string name = template_name("ln_bwd_bf16x8", U, L);
  count_launch(name.c_str());
  return e;
}

// The instances: (units, lanes) as ln_bwd_bf16_plan picks them for C up to
// kLnB16MaxC.
#define VITTA_LN_B16_INSTANCES(X) \
  X(1, 4) X(2, 4) X(3, 4) X(2, 8) X(3, 8) X(2, 16) X(3, 16) X(2, 32)      \
  X(3, 32) X(2, 64) X(3, 64) X(2, 128)

// The plan at (rows, c) with what it was made for: the clusters its
// instance's card holds at once, and the card's SMs.
inline LnB16Plan ln_bf16_plan_of(long long rows, int c, int* resident) {
  const LnB16Plan shape = ln_bwd_bf16_plan(rows, c, 1, 1);
  *resident = 0;
#define VITTA_LN_B16_RESIDENT(U, L)                                   \
  if (shape.units == U && shape.lanes == L)                           \
    *resident = LnB16Kernel<U, L>::resident();
  VITTA_LN_B16_INSTANCES(VITTA_LN_B16_RESIDENT)
#undef VITTA_LN_B16_RESIDENT
  if (*resident == 0) return shape;            // no such instance: units 0
  return ln_bwd_bf16_plan(rows, c, *resident, sm_count());
}

cudaError_t ln_bwd_bf16(const bf16* x, const float* gamma, const bf16* dy,
                        bf16* dx, float* dgb, float* scratch, long long rows,
                        int c, float eps, int slot, cudaStream_t st) {
  int resident = 0;
  const LnB16Plan q = ln_bf16_plan_of(rows, c, &resident);
  if (q.units == 0 || q.csize > kSlotTickets || slot < 0 ||
      slot >= kTicketSlots)
    return cudaErrorInvalidValue;
#define VITTA_LN_B16_CASE(U, L)                                            \
  if (q.units == U && q.lanes == L)                                        \
    return ln_bf16_launch<U, L>(q, x, gamma, dy, dx, dgb, scratch, slot,    \
                                rows, c, eps, st);
  VITTA_LN_B16_INSTANCES(VITTA_LN_B16_CASE)
#undef VITTA_LN_B16_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace vitta

extern "C" {

int vitta_ln_fwd(const float* x, const float* gamma, const float* beta,
                 float* y, long long rows, int c, float eps, void* stream) {
  if (rows < 0 || c <= 0) return (int)cudaErrorInvalidValue;
  return (int)vitta::launch_ln_rows(x, gamma, beta, y, rows, c, eps,
                                    (cudaStream_t)stream);
}

// Floats of scratch vitta_ln_bwd needs (and vitta_ln_bwd_bf16 with units
// of 4 or single values).
long long vitta_ln_bwd_scratch_floats(long long rows, int c) {
  return vitta::ln_bwd_scratch_floats(rows, c);
}

// The backward's plan, as six numbers: vec, units, batch, wpr, blocks,
// rows_per_block (LnBwdPlan); units 0 where it takes no such shape.
void vitta_ln_bwd_plan(long long rows, int c, int vec, long long* out) {
  const vitta::LnBwdPlan q = vitta::ln_bwd_plan(rows, c, vec != 0);
  const long long v[6] = {q.vec, q.units, q.batch, q.wpr, q.blocks,
                          q.rows_per_block};
  for (int k = 0; k < 6; ++k) out[k] = v[k];
}

// The bfloat16 backward's plan in 16-byte units (ln_bwd_bf16x8), as seven
// numbers: lanes, units, csize, chunk, blocks (LnB16Plan), and what it was
// made for: the clusters of 8 blocks of the instance the card holds at
// once, the card's SMs; units 0 where it takes no such shape.
void vitta_ln_bwd_bf16_plan(long long rows, int c, long long* out) {
  int resident = 0;
  const vitta::LnB16Plan q = vitta::ln_bf16_plan_of(rows, c, &resident);
  const long long v[7] = {q.lanes, q.units, q.csize, q.chunk, q.blocks,
                          resident, vitta::sm_count()};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
}

// Floats of scratch the bfloat16 backward in 16-byte units needs: its
// clusters' partials.
long long vitta_ln_bwd_bf16_scratch_floats(long long rows, int c) {
  int resident = 0;
  const vitta::LnB16Plan q = vitta::ln_bf16_plan_of(rows, c, &resident);
  return q.units == 0 ? 0 : vitta::ln_bf16_partial_floats(q, c);
}

// Streams a device may run the bfloat16 backward on at once, each with its
// own slot of tickets in 0 .. slots - 1.
int vitta_ln_slots() { return vitta::kTicketSlots; }

// dx (rows, c); dgb (2, c) = dgamma then dbeta.  Two launches.  vec: 16-byte
// units, which the caller takes only where c % 4 == 0 and x, gamma, dy and
// dx are 16-byte aligned; refused otherwise.
int vitta_ln_bwd(const float* x, const float* gamma, const float* dy,
                 float* dx, float* dgb, float* scratch, long long rows, int c,
                 float eps, int vec, void* stream) {
  if (vitta::ln_bwd_plan(rows, c, false).units == 0)
    return (int)cudaErrorInvalidValue;
  if (vec && !vitta::ln_bwd_vec_ok(x, gamma, dy, dx, c))
    return (int)cudaErrorMisalignedAddress;
  return (int)vitta::launch_ln_bwd(x, gamma, dy, dx, dgb, scratch, rows, c,
                                   eps, vec != 0, (cudaStream_t)stream);
}

// The same at bfloat16: x, y, dy, dx bfloat16; gamma, beta, dgb, scratch
// float32.
int vitta_ln_fwd_bf16(const void* x, const float* gamma, const float* beta,
                      void* y, long long rows, int c, float eps,
                      void* stream) {
  if (rows < 0 || c <= 0) return (int)cudaErrorInvalidValue;
  return (int)vitta::launch_ln_rows(reinterpret_cast<const vitta::bf16*>(x),
                                    gamma, beta,
                                    reinterpret_cast<vitta::bf16*>(y), rows,
                                    c, eps, (cudaStream_t)stream);
}

// The bfloat16 forward's plan in 16-byte units (ln_fwd_bf16x8), as seven
// numbers: lanes, units, batch, chunk, blocks (LnFwdPlan), and what it was
// made for: the blocks of the instance an SM holds, the card's SMs; units
// 0 where it takes no such shape.
void vitta_ln_fwd_bf16_plan(long long rows, int c, long long* out) {
  int per_sm = 0;
  const vitta::LnFwdPlan q = vitta::ln_fwd_bf16_plan_of(rows, c, &per_sm);
  const long long v[7] = {q.lanes, q.units, q.batch, q.chunk, q.blocks,
                          per_sm, vitta::sm_count()};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
}

// vec 2: 16-byte units of 8 values, one launch (ln_bwd_bf16x8; c % 8 == 0,
// c <= 2048, x, gamma, dy and dx 16-byte aligned, scratch as
// vitta_ln_bwd_bf16_scratch_floats says, `slot` the stream's tickets).
// vec 1: units of 4 values (8 bytes; x, dy and dx 8-byte aligned, gamma
// 16), vec 0: single values, both two launches with scratch as
// vitta_ln_bwd_scratch_floats says.  Refused where the pointers or c do not
// allow the units asked for.
int vitta_ln_bwd_bf16(const void* x, const float* gamma, const void* dy,
                      void* dx, float* dgb, float* scratch, long long rows,
                      int c, float eps, int vec, int slot, void* stream) {
  const auto* xb = reinterpret_cast<const vitta::bf16*>(x);
  const auto* dyb = reinterpret_cast<const vitta::bf16*>(dy);
  auto* dxb = reinterpret_cast<vitta::bf16*>(dx);
  if (vec == 2) {
    if (!vitta::all_aligned16({x, gamma, dy, dx}))
      return (int)cudaErrorMisalignedAddress;
    return (int)vitta::ln_bwd_bf16(xb, gamma, dyb, dxb, dgb, scratch, rows,
                                   c, eps, slot, (cudaStream_t)stream);
  }
  if (vitta::ln_bwd_plan(rows, c, false).units == 0)
    return (int)cudaErrorInvalidValue;
  if (vec && !vitta::ln_bwd_vec_ok(xb, gamma, dyb, dxb, c))
    return (int)cudaErrorMisalignedAddress;
  return (int)vitta::launch_ln_bwd(xb, gamma, dyb, dxb, dgb, scratch, rows,
                                   c, eps, vec != 0, (cudaStream_t)stream);
}

}  // extern "C"
