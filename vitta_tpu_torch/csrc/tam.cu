// TAM dynamic temporal convolution, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vitta_tpu/ops/pallas_tam.py:
//   _fwd_kernel (:77, launched by _pallas_fwd :149) and
//   _bwd_kernel (:92, launched by _pallas_bwd :177).
//
// What it computes, with y = attn * x, zero padding in T and K = 3:
//   forward   out[t] = K0*y[t-1] + K1*y[t] + K2*y[t+1]
//   backward  dy[s]  = K0*g[s+1] + K1*g[s] + K2*g[s-1]
//             dx[s]  = attn[s] * dy[s]
//             dattn[n,s,c] = sum over (h,w) of dy[s]*x[s]
//             dK[n,c,k]    = sum over (t,h,w) of g[t-k+1]*y[t]
//
// Layout: x, out, g and dx are (N, T, P, C) and contiguous, with P = H*W:
// the channels-last activations of the port, with no copy.  attn is (N, T,
// C), the kernel weights (N, C, 3), both float32.
//
// Types: float32 throughout, or bfloat16 activations (x, out, g, dx) beside
// float32 attn and weights, the bfloat16 TANet's (the TAM's branches stay
// float32).  At bfloat16 the kernels do what the JAX reference does at that
// type (vitta_tpu/ops/pallas_tam.py:50-60): attn and the weights are
// rounded to bfloat16 where they are loaded; then every product and sum is
// float32, and out and dx are rounded to bfloat16 once, where they are
// stored; dattn and dK are float32 sums.  bf16 x bf16 and bf16 x (bf16 x
// bf16) products are exact in float32, so out and dK's terms carry no
// rounding before their sums, and dy's three terms none before theirs.
//
// What bounds it: memory.  The arithmetic is a few multiply-adds per
// element; at the ResNet-50 TAM sites one adapt step moves about 0.49 GB
// in the forward (read x, write out) and 0.73 GB in the backward (read g
// and x, write dx) in float32, half that in bfloat16.  Each element is
// read and written once.
//
// Forward: one thread owns one (n, p, c) column and walks t with a
// three-deep register window; neighbouring threads own neighbouring
// channels, so every warp load and store is one contiguous line.  At
// bfloat16, where C % 8 == 0 and x, attn and out are 16-byte aligned, a
// thread owns 8 channels of the column instead (16-byte loads and stores,
// tam_fwd_bf16x8_kernel), an eighth as many threads, so it issues the
// loads of kFwdDepth frames at once; a view that starts elsewhere takes
// the one-channel kernel.
//
// Backward at float32 (and at bfloat16 where the inputs allow no 16-byte
// units: one channel a thread): at the 14x14 and 7x7 sites one column per
// thread is too few threads to keep the memory busy if each walks its 16
// frames with two loads in flight.  So:
//  * a thread owns one (n, p) column of 4 channels where C % 4 == 0 and the
//    caller's g, x, attn and dx are 16-byte aligned (16-byte loads and
//    stores; one channel where not).  A thread walks
//    chunks of kDepth frames: it issues the chunk's loads of g[t+1], x[t] and
//    attn[t] before any arithmetic, and carries g[t-1] and g[t] across
//    chunks in registers;
//  * where the grid has fewer blocks than the card has multiprocessors, T
//    is cut into segments of seg_len frames, each read with a one-frame
//    halo of g on either side: the longest segments that give at least a
//    block a multiprocessor, or one chunk each (`plan_for`).  Cutting a
//    grid that fills the card already measured slower;
//  * a block spans up to kMaxUnits units of a position (threads in x) and
//    `slots` positions (threads in y), and each thread walks `pp` positions
//    in turn, so that a block sums at least
//    kMinPositions positions: its dattn rows (one per frame of its segment)
//    and dK rows (3) are summed per thread over its positions, then over the
//    slots in shared memory in slot order, and written as partial rows of
//    about 3-6 % of x's size;
//  * the partial rows are summed in a fixed order by a second launch (warp
//    lane l adds the rows l, l+32, ... in turn, then the lanes in a
//    butterfly).  No float atomics: the result has the same bits from run
//    to run, and differs from a plain reduction only by the order of
//    float32 additions.
//
// Backward at bfloat16 with C % 8 == 0 and g, x, attn and dx 16-byte
// aligned (every TANet site): tam_bwd_bf16x8_kernel, one launch a call.  A
// call moves 5-77 MB, 1.4-23 us at the card's rate, so the second launch
// and 8-byte units cost a large share of it.  Its design:
//  * a thread owns one (n, p) column of 8 channels (16 bytes of g, x and
//    dx) and one segment of kB16Frames frames; for each of its `pp`
//    positions it issues the loads of the segment's x and of g with a
//    one-frame halo on either side (the neighbouring segments' blocks read
//    the same lines at the same time, from L2) before any arithmetic.  A
//    segment of 4 frames is what lets 8 channels a thread keep two blocks
//    an SM: the per-thread sums of dy * x for each frame (8 floats a frame)
//    are 32-byte cells in shared memory, (4 + 3) rows of them a thread,
//    56 KB a block of 256 threads where a 16-frame segment needed 152 KB;
//    attn and the weights are staged in shared memory once a block,
//    rounded;
//  * the grid is one wave of two blocks an SM (`plan_bf16`): segments of T,
//    channel chunks of up to kB16MaxUnits units and position blocks, each
//    thread walking as many positions as the wave leaves;
//  * a block adds its slots in slot order (kB16SlotParts runs of them at
//    once, then the runs in order) and writes one partial row a frame
//    (dattn) and three (dK); then it draws a ticket of its (n, channel
//    chunk, segment) (tickets.cuh).  The block that draws the last adds the
//    position blocks' rows in order, kB16SumAhead of them in flight: dattn
//    of its frames, and the segment's dK rows, which it writes as a partial
//    and draws a ticket of its (n, channel chunk); the last of those adds
//    the segments' dK rows in order.  No float atomics, no second launch.
//    Narrow chunks (kB16MaxUnits units, 32 channels) make many small tiles,
//    so that the last blocks' sums run on many SMs at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launches.cuh"
#include "tickets.cuh"

namespace {

constexpr int kFwdThreads = 256;
constexpr int kFwdDepth = 4;        // frames a bf16x8 forward thread loads at once
constexpr int kBwdThreads = 256;
// The backward's shape, as measured best (PERF.md's kernel table, row 2;
// vitta_tpu_torch/tools/tam_variants.py times other values on patched
// copies of this file).  ops/cuda_tam.py:bwd_plan mirrors them.
constexpr int kDepth = 4;           // frames whose loads a thread issues together
constexpr int kMaxUnits = 16;       // most units of a position a block spans
constexpr int kTargetBlocks = 132;  // blocks the grid aims at: an H100's SMs
constexpr int kMinBlocks = 2;       // backward blocks an SM must hold (registers)
constexpr int kMinPositions = 32;   // positions a backward block sums
constexpr int kMaxSegFrames = 16;   // bounds the block's shared memory
constexpr int kReduceThreads = 256;

// Activations of type E as float32, and back (rounded to nearest even).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <class E> __device__ __forceinline__ E from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// A float32 input (attn, a kernel weight) rounded to E, as float32: the
// identity at float32.
template <class E> __device__ __forceinline__ float round_as(float v) {
  return to_f32(from_f32<E>(v));
}

// One (n, p, c) column a thread.
template <class E>
__global__ void tam_fwd_kernel(const E* __restrict__ x,
                               const float* __restrict__ attn,
                               const float* __restrict__ kern,
                               E* __restrict__ out,
                               int T, int C, long long PC) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= PC) return;
  const int n = blockIdx.y;
  const int c = (int)(col % C);
  const float* kc = kern + ((long long)n * C + c) * 3;
  const float k0 = round_as<E>(kc[0]), k1 = round_as<E>(kc[1]),
              k2 = round_as<E>(kc[2]);
  const E* xs = x + (long long)n * T * PC + col;
  const float* as = attn + (long long)n * T * C + c;
  E* os = out + (long long)n * T * PC + col;

  float ym = 0.f;
  float y0 = round_as<E>(as[0]) * to_f32(xs[0]);
  for (int t = 0; t < T; ++t) {
    const float yp = (t + 1 < T)
        ? round_as<E>(as[(t + 1) * C]) * to_f32(xs[(t + 1) * PC]) : 0.f;
    os[t * PC] = from_f32<E>(k0 * ym + k1 * y0 + k2 * yp);
    ym = y0;
    y0 = yp;
  }
}

// bfloat16 with C % 8 == 0 and 16-byte-aligned x, attn and out: 8
// channels of one (n, p) a thread, 16-byte loads and stores of x and out
// (two of attn's 8 floats), the same arithmetic as tam_fwd_kernel's.
__device__ __forceinline__ void unpack8(uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void attn8(const float* p, float (&a)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = round_as<__nv_bfloat16>(v[j]);
}

__global__ void tam_fwd_bf16x8_kernel(const uint4* __restrict__ x,
                                      const float* __restrict__ attn,
                                      const float* __restrict__ kern,
                                      uint4* __restrict__ out, int T, int C,
                                      long long PU) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= PU) return;
  const int n = blockIdx.y;
  const int c = (int)(u % (C / 8)) * 8;
  const float* kc = kern + ((long long)n * C + c) * 3;
  float k0[8], k1[8], k2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    k0[j] = round_as<__nv_bfloat16>(kc[3 * j]);
    k1[j] = round_as<__nv_bfloat16>(kc[3 * j + 1]);
    k2[j] = round_as<__nv_bfloat16>(kc[3 * j + 2]);
  }
  const uint4* xs = x + (long long)n * T * PU + u;
  const float* as = attn + (long long)n * T * C + c;
  uint4* os = out + (long long)n * T * PU + u;

  float ym[8], y0[8], a[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) ym[j] = 0.f;
  unpack8(xs[0], y0);
  attn8(as, a);
#pragma unroll
  for (int j = 0; j < 8; ++j) y0[j] *= a[j];
  // frames t0 .. t0 + kFwdDepth - 1: the loads of x[t + 1] and attn[t + 1]
  // for all of them are issued before any arithmetic
  for (int t0 = 0; t0 < T; t0 += kFwdDepth) {
    uint4 xn[kFwdDepth];
    float4 an[kFwdDepth][2];
#pragma unroll
    for (int d = 0; d < kFwdDepth; ++d) {
      const int t = t0 + d + 1;
      if (t < T) {
        xn[d] = xs[t * PU];
        an[d][0] = *reinterpret_cast<const float4*>(as + t * C);
        an[d][1] = *reinterpret_cast<const float4*>(as + t * C + 4);
      }
    }
#pragma unroll
    for (int d = 0; d < kFwdDepth; ++d) {
      const int t = t0 + d;
      if (t < T) {
        float yp[8];
        if (t + 1 < T) {
          unpack8(xn[d], yp);
          const float av[8] = {an[d][0].x, an[d][0].y, an[d][0].z,
                               an[d][0].w, an[d][1].x, an[d][1].y,
                               an[d][1].z, an[d][1].w};
#pragma unroll
          for (int j = 0; j < 8; ++j) yp[j] *= round_as<__nv_bfloat16>(av[j]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) yp[j] = 0.f;
        }
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[j] = k0[j] * ym[j] + k1[j] * y0[j] + k2[j] * yp[j];
          ym[j] = y0[j];
          y0[j] = yp[j];
        }
        os[t * PU] = pack8(o);
      }
    }
  }
}

// ---- the backward ---------------------------------------------------------
// Lane arithmetic on a unit of columns: float4 (4 channels) or float.
__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 operator*(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ void operator+=(float4& a, float4 b) { a = a + b; }
template <class V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ float4 shfl_xor(float4 v, int o) {
  return make_float4(shfl_xor(v.x, o), shfl_xor(v.y, o), shfl_xor(v.z, o),
                     shfl_xor(v.w, o));
}
__device__ __forceinline__ float comp(float v, int) { return v; }
__device__ __forceinline__ float comp(float4 v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}
// K[n, c, k] for the unit's channels, rounded to E, as a unit
template <class E>
__device__ __forceinline__ float kern_unit(const float* kc, int k, float*) {
  return round_as<E>(kc[k]);
}
template <class E>
__device__ __forceinline__ float4 kern_unit(const float* kc, int k, float4*) {
  return make_float4(round_as<E>(kc[k]), round_as<E>(kc[3 + k]),
                     round_as<E>(kc[6 + k]), round_as<E>(kc[9 + k]));
}
// attn's unit rounded to E
template <class E> __device__ __forceinline__ float round_unit(float v) {
  return round_as<E>(v);
}
template <class E> __device__ __forceinline__ float4 round_unit(float4 v) {
  return make_float4(round_as<E>(v.x), round_as<E>(v.y), round_as<E>(v.z),
                     round_as<E>(v.w));
}

// A unit of V's width of activations of type E: how it lies in memory
// (raw) and its values as V.
template <class V, class E> struct Act;
template <class V> struct Act<V, float> {
  using raw = V;
  static __device__ __forceinline__ V load(raw r) { return r; }
  static __device__ __forceinline__ raw store(V v) { return v; }
};
template <> struct Act<float, __nv_bfloat16> {
  using raw = __nv_bfloat16;
  static __device__ __forceinline__ float load(raw r) {
    return __bfloat162float(r);
  }
  static __device__ __forceinline__ raw store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// How the backward cuts its work; `vitta_tam_bwd_plan` exports it and
// vitta_tpu_torch/ops/cuda_tam.py:bwd_plan mirrors it.
struct Plan {
  int vec;        // C % 4 == 0: units of 4 channels
  int units;      // units per position: C / 4 or C
  int wc;         // units a block spans (threads in x)
  int slots;      // positions a block walks at once (threads in y)
  int pp;         // positions each thread walks in turn
  int seg_len;    // frames of a segment, a multiple of kDepth
  int nseg;       // segments of T
  int npb;        // position blocks
  int ncc;        // channel chunks
};

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// vec: C % 4 == 0 and the caller's g, x, attn and dx start on 16-byte
// boundaries (float32; at bfloat16 this plan takes one channel a thread)
Plan plan_for(int N, int T, int P, int C, bool vec) {
  Plan q;
  q.vec = vec;
  q.units = q.vec ? C / 4 : C;
  q.wc = q.units < kMaxUnits ? q.units : kMaxUnits;
  q.slots = kBwdThreads / q.wc;
  q.pp = cdiv(kMinPositions, q.slots);
  q.npb = cdiv(P, (long long)q.slots * q.pp);
  q.ncc = cdiv(q.units, q.wc);
  const long long blocks = (long long)N * q.ncc * q.npb;
  // at least `want` segments: each of at most 1/want of T's chunks
  const int want = blocks >= kTargetBlocks ? 1 : cdiv(kTargetBlocks, blocks);
  int chunks = cdiv(T, kDepth) / want;
  chunks = chunks > 1 ? chunks : 1;
  const int most = kMaxSegFrames / kDepth > 0 ? kMaxSegFrames / kDepth : 1;
  chunks = chunks < most ? chunks : most;
  q.seg_len = chunks * kDepth;
  q.nseg = cdiv(T, q.seg_len);
  return q;
}

long long part_a_floats(const Plan& q, int N, int T, int C) {
  return (long long)N * q.npb * T * C;
}
long long part_k_floats(const Plan& q, int N, int C) {
  return (long long)N * q.nseg * q.npb * 3 * C;
}

// One output of the sum over partial rows: dattn[n, r, unit] (r < T) over
// the position blocks, or dK[n, unit, r - T] over (segment, position
// block), by a whole warp: lane l adds rows l, l + 32, ... in turn, then
// the lanes are added in a butterfly.
template <class V>
__device__ void sum_output(const V* __restrict__ part_a,
                           const V* __restrict__ part_k,
                           float* __restrict__ dattn,
                           float* __restrict__ dkern, int l, int n, int r,
                           int u, int T, int U, int npb, int nseg) {
  const V* src;
  long long step;
  int count;
  if (r < T) {
    src = part_a + ((long long)n * npb * T + r) * U + u;
    step = (long long)T * U;
    count = npb;
  } else {
    src = part_k + ((long long)n * nseg * npb * 3 + (r - T)) * U + u;
    step = 3LL * U;
    count = nseg * npb;
  }
  // four rows' loads in flight at a time, added in the same order
  V acc = zero<V>();
  for (int j0 = l; j0 < count; j0 += 4 * 32) {
    V v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = j0 + 32 * e < count ? src[(j0 + 32 * e) * step] : zero<V>();
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j0 + 32 * e < count) acc += v[e];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += shfl_xor(acc, o);
  if (l != 0) return;
  constexpr int W = sizeof(V) / sizeof(float);
  if (r < T) {
    reinterpret_cast<V*>(dattn)[((long long)n * T + r) * U + u] = acc;
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q)
      dkern[((long long)n * U * W + u * W + q) * 3 + (r - T)] = comp(acc, q);
  }
}

// grid (ncc, npb, N * nseg), block (wc, slots).  Shared memory holds one
// slot per thread for each of the segment's dattn rows and the 3 dK rows.
// g, x and dx are activations of type E (A's raw units), everything else
// float32; the arithmetic is V's, float32.
template <class V, class E>
__global__ void __launch_bounds__(kBwdThreads, kMinBlocks)
tam_bwd_kernel(const typename Act<V, E>::raw* __restrict__ g,
               const typename Act<V, E>::raw* __restrict__ x,
               const V* __restrict__ attn, const float* __restrict__ kern,
               typename Act<V, E>::raw* __restrict__ dx,
               V* __restrict__ part_a, V* __restrict__ part_k, int T, int P,
               int U, int seg_len, int nseg, int pp) {
  using A = Act<V, E>;
  extern __shared__ __align__(16) unsigned char smem[];
  V* sh = reinterpret_cast<V*>(smem);
  constexpr int W = sizeof(V) / sizeof(float);
  const int wc = blockDim.x, slots = blockDim.y;
  const int slot = threadIdx.y * wc + threadIdx.x;
  const int rs = wc * slots;                 // a shared row's stride
  const int u = blockIdx.x * wc + threadIdx.x;
  const int pb = blockIdx.y, npb = gridDim.y;
  const int n = blockIdx.z / nseg, seg = blockIdx.z - n * nseg;
  const int t0 = seg * seg_len;
  const int t1 = T < t0 + seg_len ? T : t0 + seg_len;
  const int L = t1 - t0;
  const long long PU = (long long)P * U;    // a frame, in units

  V k0 = zero<V>(), k1 = zero<V>(), k2 = zero<V>();
  V dk0 = zero<V>(), dk1 = zero<V>(), dk2 = zero<V>();
  if (u < U) {
    const float* kc = kern + ((long long)n * U + u) * W * 3;
    k0 = kern_unit<E>(kc, 0, (V*)nullptr);
    k1 = kern_unit<E>(kc, 1, (V*)nullptr);
    k2 = kern_unit<E>(kc, 2, (V*)nullptr);
  }
  for (int m = 0; m < pp; ++m) {
    const int p = (pb * pp + m) * slots + threadIdx.y;
    if (u >= U || p >= P) {        // so are the thread's later positions
      if (m == 0)
        for (int r = 0; r < L; ++r) sh[r * rs + slot] = zero<V>();
      break;
    }
    const long long col = ((long long)n * T * P + p) * U + u;
    const typename A::raw* gs = g + col;
    const typename A::raw* xs = x + col;
    const V* as = attn + (long long)n * T * U + u;
    typename A::raw* ds = dx + col;
    V gm = t0 > 0 ? A::load(gs[(t0 - 1) * PU]) : zero<V>();
    V gc = A::load(gs[t0 * PU]);
    for (int c0 = t0; c0 < t1; c0 += kDepth) {
      V gn[kDepth], xv[kDepth], av[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int t = c0 + d;
        gn[d] = (t < t1 && t + 1 < T) ? A::load(gs[(t + 1) * PU]) : zero<V>();
        xv[d] = t < t1 ? A::load(xs[t * PU]) : zero<V>();
        av[d] = t < t1 ? round_unit<E>(as[t * U]) : zero<V>();
      }
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int t = c0 + d;
        if (t < t1) {
          const V dy = k0 * gn[d] + k1 * gc + k2 * gm;
          ds[t * PU] = A::store(av[d] * dy);
          const V q = dy * xv[d];
          V& cell = sh[(t - t0) * rs + slot];
          cell = m == 0 ? q : cell + q;
          const V y = av[d] * xv[d];
          dk0 += gn[d] * y;
          dk1 += gc * y;
          dk2 += gm * y;
          gm = gc;
          gc = gn[d];
        }
      }
    }
  }
  sh[L * rs + slot] = dk0;
  sh[(L + 1) * rs + slot] = dk1;
  sh[(L + 2) * rs + slot] = dk2;
  __syncthreads();

  // each (row, unit) summed over the slots in slot order: one partial row
  for (int o = slot; o < (L + 3) * wc; o += rs) {
    const int r = o / wc, ux = o - r * wc;
    const int uu = blockIdx.x * wc + ux;
    if (uu >= U) continue;
    V s = sh[r * rs + ux];
    for (int y = 1; y < slots; ++y) s += sh[r * rs + y * wc + ux];
    if (r < L)
      part_a[(((long long)n * npb + pb) * T + t0 + r) * U + uu] = s;
    else
      part_k[((((long long)n * nseg + seg) * npb + pb) * 3 + (r - L)) * U +
             uu] = s;
  }
}

// A warp per output (n, row, unit) of dattn and dK.
template <class V>
__global__ void __launch_bounds__(kReduceThreads)
tam_bwd_reduce_kernel(const V* __restrict__ part_a,
                      const V* __restrict__ part_k, float* __restrict__ dattn,
                      float* __restrict__ dkern, int N, int T, int U,
                      int npb, int nseg) {
  const long long w =
      ((long long)blockIdx.x * kReduceThreads + threadIdx.x) >> 5;
  if (w >= (long long)N * (T + 3) * U) return;
  const int u = (int)(w % U);
  const int r = (int)((w / U) % (T + 3));
  const int n = (int)(w / ((long long)U * (T + 3)));
  sum_output(part_a, part_k, dattn, dkern, threadIdx.x & 31, n, r, u, T,
             U, npb, nseg);
}

// The name a profiler gives the instance, for the library's launch counts.
template <class V, class E> const char* bwd_kernel_name();
template <> const char* bwd_kernel_name<float4, float>() {
  return "tam_bwd_kernel<float4>";
}
template <> const char* bwd_kernel_name<float, float>() {
  return "tam_bwd_kernel<float>";
}
template <> const char* bwd_kernel_name<float, __nv_bfloat16>() {
  return "tam_bwd_kernel<float, __nv_bfloat16>";
}

template <class V, class E>
int launch_bwd(const Plan& q, const void* g, const void* x,
               const float* attn, const float* kern, void* dx,
               float* scratch, float* dattn, float* dkern, int N, int T,
               int P, int C, cudaStream_t s) {
  using R = typename Act<V, E>::raw;
  const size_t smem = (size_t)(q.seg_len + 3) * q.wc * q.slots * sizeof(V);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tam_bwd_kernel<V, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  V* part_a = reinterpret_cast<V*>(scratch);
  V* part_k = reinterpret_cast<V*>(scratch + part_a_floats(q, N, T, C));
  const dim3 grid(q.ncc, q.npb, N * q.nseg);
  const dim3 block(q.wc, q.slots);
  tam_bwd_kernel<V, E><<<grid, block, smem, s>>>(
      reinterpret_cast<const R*>(g), reinterpret_cast<const R*>(x),
      reinterpret_cast<const V*>(attn), kern, reinterpret_cast<R*>(dx),
      part_a, part_k, T, P, q.units, q.seg_len, q.nseg, q.pp);
  vitta::count_launch(bwd_kernel_name<V, E>());
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long threads = (long long)N * (T + 3) * q.units * 32;
  tam_bwd_reduce_kernel<V>
      <<<cdiv(threads, kReduceThreads), kReduceThreads, 0, s>>>(
          part_a, part_k, dattn, dkern, N, T, q.units, q.npb, q.nseg);
  vitta::count_launch(sizeof(V) == 16 ? "tam_bwd_reduce_kernel<float4>"
                                      : "tam_bwd_reduce_kernel<float>");
  return (int)cudaGetLastError();
}

// ---- the bfloat16 backward in 16-byte units, one launch ---------------------
// Its shape, as measured best (PERF.md's kernel table, row 2 bf16;
// vitta_tpu_torch/tools/tam_variants.py times other values on patched
// copies of this file).  ops/cuda_tam.py:bwd_plan_bf16 mirrors the plan.
constexpr int kB16Threads = 256;
constexpr int kB16BlocksPerSm = 2;  // blocks an SM holds, and the grid aims at
constexpr int kB16Frames = 4;       // frames of a segment
constexpr int kB16MaxUnits = 4;     // most 8-channel units of a position a block spans
constexpr int kB16SumAhead = 8;     // partial rows the last blocks load at once
constexpr int kB16SlotParts = 8;    // parts of the slots a block adds at once
constexpr int kB16Rows = kB16Frames + 3;   // a block's partial rows
// outputs a thread of the last blocks adds: a block's rows of wc units of
// 8 channels over its wc * floor(kB16Threads / wc) threads
constexpr int kB16Outs = (kB16Rows * 8 + kB16Threads / kB16MaxUnits - 1) /
                         (kB16Threads / kB16MaxUnits);

// How tam_bwd_bf16x8_kernel cuts (N, T, P, C), units of 8 channels: blocks
// of wc units (threads in x) x slots positions (threads in y), each thread
// walking pp positions in turn; T in nseg segments of kB16Frames frames,
// ncc channel chunks, npb position blocks; blocks = N ncc npb nseg, at most
// kB16BlocksPerSm an SM of `sms` where the positions allow (pp as small as
// that leaves).
struct PlanB16 {
  int units, wc, slots, pp, nseg, npb, ncc;
  long long blocks;
};

PlanB16 plan_bf16(int N, int T, int P, int C, int sms) {
  PlanB16 q;
  q.units = C / 8;
  q.wc = q.units < kB16MaxUnits ? q.units : kB16MaxUnits;
  q.slots = kB16Threads / q.wc;
  q.ncc = cdiv(q.units, q.wc);
  q.nseg = cdiv(T, kB16Frames);
  const long long per = (long long)N * q.ncc * q.nseg;
  const long long wave = (long long)kB16BlocksPerSm * sms;
  const long long most = wave / per > 1 ? wave / per : 1;   // position blocks
  q.pp = cdiv(P, most * q.slots);
  q.npb = cdiv(P, (long long)q.slots * q.pp);
  q.blocks = per * q.npb;
  return q;
}

// Tickets a call draws on: one per (n, chunk, segment), one per (n, chunk).
long long tickets_bf16(const PlanB16& q, int N) {
  return (long long)N * q.ncc * (q.nseg + 1);
}

// The partials, in floats: dattn rows (tile, position block, frame, unit),
// dK rows (tile, position block, 3, unit), then the segments' dK rows (n
// and chunk, segment, 3, unit), a row of wc units of 8 channels each.
long long part_bf16_floats(const PlanB16& q, int N) {
  const long long row = 8LL * q.wc, tiles = (long long)N * q.ncc * q.nseg;
  return tiles * q.npb * kB16Rows * row + tiles * 3 * row;
}

// Shared memory of a block: the cells (kB16Rows rows of a 32-byte cell a
// thread), the sums of kB16SlotParts parts of its slots (parts x rows x
// units x 8), attn's segment (frames x units x 8) and the weights (units x
// 3 x 8), rounded to bfloat16.
size_t smem_bf16(const PlanB16& q) {
  return ((size_t)kB16Rows * q.wc * (q.slots + kB16SlotParts) * 8 +
          kB16Frames * q.wc * 8 + q.wc * 24) * sizeof(float);
}

__device__ __forceinline__ void add4(float* p, float a, float b, float c,
                                     float d) {
  float4 v = *reinterpret_cast<float4*>(p);
  v.x += a, v.y += b, v.z += c, v.w += d;
  *reinterpret_cast<float4*>(p) = v;
}

// grid (blocks), block (wc, slots), dynamic shared memory smem_bf16.
// Block b is (n, chunk cc, position block pb, segment seg), seg varying
// fastest; thread (ux, y) takes unit cc * wc + ux of positions (pb * pp +
// m) * slots + y, m < pp, and frames seg * kB16Frames .. + kB16Frames - 1.
// dattn (N, T, C) and dkern (N, C, 3) float32; part as part_bf16_floats.
__global__ void __launch_bounds__(kB16Threads, kB16BlocksPerSm)
tam_bwd_bf16x8_kernel(const uint4* __restrict__ g, const uint4* __restrict__ x,
                      const float* __restrict__ attn,
                      const float* __restrict__ kern, uint4* __restrict__ dx,
                      float* __restrict__ dattn, float* __restrict__ dkern,
                      float* __restrict__ part, int ticket_slot, int T,
                      int P, int U, int ncc, int npb, int nseg, int pp) {
  extern __shared__ __align__(16) float sm[];
  const int wc = blockDim.x, slots = blockDim.y, rs = wc * slots;
  const int ux = threadIdx.x, y = threadIdx.y, slot = y * wc + ux;
  float* cells = sm;                             // (kB16Rows, rs, 8)
  float* parts = cells + (size_t)kB16Rows * rs * 8;  // (kB16SlotParts,
                                                 //  kB16Rows, wc, 8)
  float* as = parts + kB16SlotParts * kB16Rows * wc * 8;   // (kB16Frames,
                                                           //  wc, 8)
  float* ks = as + kB16Frames * wc * 8;          // (wc, 3, 8)
  __shared__ int last;
  long long b = blockIdx.x;
  const int seg = (int)(b % nseg);
  b /= nseg;
  const int pb = (int)(b % npb);
  b /= npb;
  const int cc = (int)(b % ncc), n = (int)(b / ncc);
  const int C = U * 8, wc8 = wc * 8, t0 = seg * kB16Frames;
  const long long tile = ((long long)n * ncc + cc) * nseg + seg;
  const long long tile2 = (long long)n * ncc + cc;
  const long long tiles = (long long)gridDim.x / npb;   // N ncc nseg
  unsigned* tickets = vitta::slot_tickets(ticket_slot);

  // attn's segment and the weights, rounded, a value a thread; the cells 0
  for (int i = slot; i < kB16Frames * wc8; i += rs) {
    const int r = i / wc8, k8 = i - r * wc8, uu = cc * wc + k8 / 8;
    const int t = t0 + r;
    as[i] = t < T && uu < U
                ? round_as<__nv_bfloat16>(attn[((long long)n * T + t) * C +
                                               uu * 8 + (k8 & 7)])
                : 0.f;
  }
  for (int i = slot; i < wc * 24; i += rs) {
    const int u2 = i / 24, j = i - u2 * 24, k = j / 8, ch = j & 7;
    const int uu = cc * wc + u2;
    ks[i] = uu < U ? round_as<__nv_bfloat16>(
                         kern[((long long)n * C + uu * 8 + ch) * 3 + k])
                   : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kB16Frames; ++r) {
    float* c8 = cells + ((size_t)r * rs + slot) * 8;
    *reinterpret_cast<float4*>(c8) = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(c8 + 4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const int u = cc * wc + ux;
  const long long FU = (long long)P * U;        // a frame, in units
  float dk[3][8];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk[k][j] = 0.f;
  const float* kx = ks + ux * 24;
  for (int m = 0; m < pp; ++m) {
    const int p = (pb * pp + m) * slots + y;
    if (u >= U || p >= P) break;           // so are its later positions
    const long long col = ((long long)n * T * P + p) * U + u;
    // the segment's x and g with its halo, all loads before any arithmetic
    uint4 gv[kB16Frames + 2], xv[kB16Frames];
#pragma unroll
    for (int f = 0; f < kB16Frames + 2; ++f) {
      const int t = t0 - 1 + f;
      gv[f] = t >= 0 && t < T ? g[col + t * FU] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int d = 0; d < kB16Frames; ++d) {
      const int t = t0 + d;
      xv[d] = t < T ? x[col + t * FU] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int d = 0; d < kB16Frames; ++d) {
      if (t0 + d >= T) break;
      float gm[8], gc[8], gn[8], xf[8], o[8];
      unpack8(gv[d], gm);
      unpack8(gv[d + 1], gc);
      unpack8(gv[d + 2], gn);
      unpack8(xv[d], xf);
      float* c8 = cells + ((size_t)d * rs + slot) * 8;
#pragma unroll
      for (int h = 0; h < 8; h += 4) {     // four channels at a time
        const float4 k0 = *reinterpret_cast<const float4*>(kx + h);
        const float4 k1 = *reinterpret_cast<const float4*>(kx + 8 + h);
        const float4 k2 = *reinterpret_cast<const float4*>(kx + 16 + h);
        const float4 a4 =
            *reinterpret_cast<const float4*>(as + (d * wc + ux) * 8 + h);
        const float kk0[4] = {k0.x, k0.y, k0.z, k0.w};
        const float kk1[4] = {k1.x, k1.y, k1.z, k1.w};
        const float kk2[4] = {k2.x, k2.y, k2.z, k2.w};
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        float q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = h + j;
          const float dy = kk0[j] * gn[c] + kk1[j] * gc[c] + kk2[j] * gm[c];
          o[c] = av[j] * dy;
          q[j] = dy * xf[c];
          const float yv = av[j] * xf[c];
          dk[0][c] += gn[c] * yv;
          dk[1][c] += gc[c] * yv;
          dk[2][c] += gm[c] * yv;
        }
        add4(c8 + h, q[0], q[1], q[2], q[3]);
      }
      dx[col + (t0 + d) * FU] = pack8(o);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float* c8 = cells + ((size_t)(kB16Frames + k) * rs + slot) * 8;
    *reinterpret_cast<float4*>(c8) =
        make_float4(dk[k][0], dk[k][1], dk[k][2], dk[k][3]);
    *reinterpret_cast<float4*>(c8 + 4) =
        make_float4(dk[k][4], dk[k][5], dk[k][6], dk[k][7]);
  }
  __syncthreads();

  // each (row, unit) over the slots in slot order, kB16SlotParts runs of
  // sp slots at once, then the runs in order: the block's partial rows
  const int sp = (slots + kB16SlotParts - 1) / kB16SlotParts;
  for (int it = slot; it < kB16SlotParts * kB16Rows * wc; it += rs) {
    const int q = it / (kB16Rows * wc), o = it - q * kB16Rows * wc;
    const int r = o / wc, ox = o - r * wc;
    const float* c0 = cells + (size_t)r * rs * 8 + ox * 8;
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
    const int y1 = (q + 1) * sp < slots ? (q + 1) * sp : slots;
    for (int yy = q * sp; yy < y1; ++yy) {
      const float4 v0 = *reinterpret_cast<const float4*>(c0 + yy * wc * 8);
      const float4 v1 =
          *reinterpret_cast<const float4*>(c0 + yy * wc * 8 + 4);
      s0.x += v0.x, s0.y += v0.y, s0.z += v0.z, s0.w += v0.w;
      s1.x += v1.x, s1.y += v1.y, s1.z += v1.z, s1.w += v1.w;
    }
    *reinterpret_cast<float4*>(parts + (size_t)it * 8) = s0;
    *reinterpret_cast<float4*>(parts + (size_t)it * 8 + 4) = s1;
  }
  __syncthreads();
  float* pa = part + (tile * npb + pb) * kB16Rows * wc8;
  for (int o = slot; o < kB16Rows * wc * 2; o += rs) {   // a float4 each
    const int r = o / (2 * wc), h = o - r * 2 * wc, ox = h / 2;
    if (cc * wc + ox >= U) continue;
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < kB16SlotParts; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          parts + ((size_t)(q * kB16Rows + r) * wc + ox) * 8 + (h & 1) * 4);
      s0.x += v.x, s0.y += v.y, s0.z += v.z, s0.w += v.w;
    }
    *reinterpret_cast<float4*>(pa + r * wc8 + ox * 8 + (h & 1) * 4) = s0;
  }
  __syncthreads();
  if (slot == 0) last = vitta::draw_last_ticket(tickets + tile, npb);
  __syncthreads();
  if (!last) return;

  // the position blocks' rows in order: dattn of the segment's frames, and
  // the segment's dK rows as a partial of (n, chunk).  A thread adds up to
  // kB16Outs outputs (kB16Rows * wc8 <= kB16Outs * rs), the loads of
  // kB16SumAhead position blocks of each in flight together
  float* pk2 = part + tiles * npb * kB16Rows * wc8 +
               (tile2 * nseg + seg) * 3 * wc8;
  const float* src = part + tile * npb * kB16Rows * wc8;
  bool want[kB16Outs];
  float acc[kB16Outs];
#pragma unroll
  for (int j = 0; j < kB16Outs; ++j) {
    const int o = slot + j * rs, r = o / wc8, k8 = o - r * wc8;
    want[j] = o < kB16Rows * wc8 && cc * wc + k8 / 8 < U &&
              !(r < kB16Frames && t0 + r >= T);
    acc[j] = 0.f;
  }
#pragma unroll 1
  for (int p0 = 0; p0 < npb; p0 += kB16SumAhead) {
    float v[kB16Outs][kB16SumAhead];
#pragma unroll
    for (int j = 0; j < kB16Outs; ++j)
#pragma unroll
      for (int e = 0; e < kB16SumAhead; ++e)
        v[j][e] = want[j] && p0 + e < npb
                      ? __ldcg(src + (long long)(p0 + e) * kB16Rows * wc8 +
                               slot + j * rs)
                      : 0.f;
#pragma unroll
    for (int j = 0; j < kB16Outs; ++j)
#pragma unroll
      for (int e = 0; e < kB16SumAhead; ++e)
        if (p0 + e < npb) acc[j] += v[j][e];
  }
#pragma unroll
  for (int j = 0; j < kB16Outs; ++j) {
    if (!want[j]) continue;
    const int o = slot + j * rs, r = o / wc8, k8 = o - r * wc8;
    const int uu = cc * wc + k8 / 8;
    if (r < kB16Frames)
      dattn[((long long)n * T + t0 + r) * C + uu * 8 + (k8 & 7)] = acc[j];
    else
      pk2[(r - kB16Frames) * wc8 + k8] = acc[j];
  }
  __syncthreads();
  if (slot == 0) last = vitta::draw_last_ticket(tickets + tiles + tile2, nseg);
  __syncthreads();
  if (!last) return;

  // the segments' dK rows in order
  const float* pk = part + tiles * npb * kB16Rows * wc8 + tile2 * nseg * 3 * wc8;
  for (int o = slot; o < 3 * wc8; o += rs) {
    const int k = o / wc8, k8 = o - k * wc8, uu = cc * wc + k8 / 8;
    if (uu >= U) continue;
    float s = 0.f;
#pragma unroll 1
    for (int s0 = 0; s0 < nseg; s0 += kB16SumAhead) {
      float v[kB16SumAhead];
#pragma unroll
      for (int e = 0; e < kB16SumAhead; ++e)
        v[e] = s0 + e < nseg ? __ldcg(pk + (s0 + e) * 3 * wc8 + o) : 0.f;
#pragma unroll
      for (int e = 0; e < kB16SumAhead; ++e)
        if (s0 + e < nseg) s += v[e];
    }
    dkern[((long long)n * C + uu * 8 + (k8 & 7)) * 3 + k] = s;
  }
}

int launch_bwd_bf16(const PlanB16& q, const void* g, const void* x,
                    const float* attn, const float* kern, void* dx,
                    float* scratch, float* dattn, float* dkern, int N, int T,
                    int P, int slot, cudaStream_t s) {
  const size_t smem = smem_bf16(q);
  static const cudaError_t attr = cudaFuncSetAttribute(
      tam_bwd_bf16x8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bf16(PlanB16{kB16MaxUnits, kB16MaxUnits,
                             kB16Threads / kB16MaxUnits, 1, 1, 1, 1, 1}));
  if (attr != cudaSuccess) return (int)attr;
  tam_bwd_bf16x8_kernel<<<(unsigned)q.blocks, dim3(q.wc, q.slots), smem, s>>>(
      reinterpret_cast<const uint4*>(g), reinterpret_cast<const uint4*>(x),
      attn, kern, reinterpret_cast<uint4*>(dx), dattn, dkern, scratch,
      slot, T, P, q.units, q.ncc, q.npb, q.nseg, q.pp);
  vitta::count_launch("tam_bwd_bf16x8_kernel");
  return (int)cudaGetLastError();
}

bool bad_dims(int N, int T, int P, int C) {
  return N <= 0 || T <= 0 || P <= 0 || C <= 0 || N > 65535;
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}
bool aligned16(const void* p) { return aligned(p, 16); }

}  // namespace

extern "C" {

// The backward takes 16-byte units (vec = 1) only where C % 4 == 0 and the
// caller's g, x, attn and dx are 16-byte aligned; the caller decides, and
// passes the same vec to these three functions.

// Floats of scratch the backward needs: its partial rows.
long long vitta_tam_bwd_scratch_floats(int N, int T, int P, int C, int vec) {
  const Plan q = plan_for(N, T, P, C, vec != 0);
  return part_a_floats(q, N, T, C) + part_k_floats(q, N, C);
}

// The backward's plan, as the nine ints of `Plan` in order.
void vitta_tam_bwd_plan(int N, int T, int P, int C, int vec, int* out) {
  const Plan q = plan_for(N, T, P, C, vec != 0);
  const int v[9] = {q.vec, q.units, q.wc, q.slots, q.pp,
                    q.seg_len, q.nseg, q.npb, q.ncc};
  for (int k = 0; k < 9; ++k) out[k] = v[k];
}

int vitta_tam_fwd(const float* x, const float* attn, const float* kern,
                  float* out, int N, int T, int P, int C, void* stream) {
  if (bad_dims(N, T, P, C)) return (int)cudaErrorInvalidValue;
  const long long PC = (long long)P * C;
  const dim3 grid((unsigned)((PC + kFwdThreads - 1) / kFwdThreads), N);
  tam_fwd_kernel<float><<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(
      x, attn, kern, out, T, C, PC);
  vitta::count_launch("tam_fwd_kernel");
  return (int)cudaGetLastError();
}

int vitta_tam_bwd(const float* g, const float* x, const float* attn,
                  const float* kern, float* dx, float* scratch, float* dattn,
                  float* dkern, int N, int T, int P, int C, int vec,
                  void* stream) {
  if (bad_dims(N, T, P, C)) return (int)cudaErrorInvalidValue;
  if (vec && (C % 4 != 0 || !aligned16(g) || !aligned16(x) ||
              !aligned16(attn) || !aligned16(dx)))
    return (int)cudaErrorMisalignedAddress;
  const Plan q = plan_for(N, T, P, C, vec != 0);
  if (q.npb > 65535 || (long long)N * q.nseg > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return q.vec ? launch_bwd<float4, float>(q, g, x, attn, kern, dx, scratch,
                                           dattn, dkern, N, T, P, C, s)
               : launch_bwd<float, float>(q, g, x, attn, kern, dx, scratch,
                                          dattn, dkern, N, T, P, C, s);
}

// bfloat16 x and out, float32 attn and kern.  vec = 1: C % 8 == 0 and x,
// attn and out 16-byte aligned (8 channels a thread; the caller decides),
// else one channel a thread.
int vitta_tam_fwd_bf16(const void* x, const float* attn, const float* kern,
                       void* out, int N, int T, int P, int C, int vec,
                       void* stream) {
  if (bad_dims(N, T, P, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long PC = (long long)P * C;
  if (vec) {
    if (C % 8 != 0 || !aligned16(x) || !aligned16(attn) || !aligned16(out))
      return (int)cudaErrorMisalignedAddress;
    const long long PU = PC / 8;
    const dim3 grid((unsigned)((PU + kFwdThreads - 1) / kFwdThreads), N);
    tam_fwd_bf16x8_kernel<<<grid, kFwdThreads, 0, s>>>(
        reinterpret_cast<const uint4*>(x), attn, kern,
        reinterpret_cast<uint4*>(out), T, C, PU);
    vitta::count_launch("tam_fwd_bf16x8_kernel");
  } else {
    const dim3 grid((unsigned)((PC + kFwdThreads - 1) / kFwdThreads), N);
    tam_fwd_kernel<__nv_bfloat16><<<grid, kFwdThreads, 0, s>>>(
        reinterpret_cast<const __nv_bfloat16*>(x), attn, kern,
        reinterpret_cast<__nv_bfloat16*>(out), T, C, PC);
    vitta::count_launch("tam_fwd_kernel<__nv_bfloat16>");
  }
  return (int)cudaGetLastError();
}

// The bfloat16 backward's plan in 16-byte units (tam_bwd_bf16x8_kernel), as
// the nine numbers units, wc, slots, pp, nseg, npb, ncc, blocks (PlanB16)
// and the card's SMs it was made for.
void vitta_tam_bwd_bf16_plan(int N, int T, int P, int C, long long* out) {
  const int sms = vitta::sm_count();
  const PlanB16 q = plan_bf16(N, T, P, C, sms);
  const long long v[9] = {q.units, q.wc, q.slots, q.pp, q.nseg,
                          q.npb, q.ncc, q.blocks, sms};
  for (int k = 0; k < 9; ++k) out[k] = v[k];
}

// Floats of scratch vitta_tam_bwd_bf16 needs: vec 1 (16-byte units) its
// partials, vec 0 (one channel) as vitta_tam_bwd_scratch_floats.
long long vitta_tam_bwd_bf16_scratch_floats(int N, int T, int P, int C,
                                            int vec) {
  if (!vec) return vitta_tam_bwd_scratch_floats(N, T, P, C, 0);
  return part_bf16_floats(plan_bf16(N, T, P, C, vitta::sm_count()), N);
}

// Streams a device may run the bfloat16 backward on at once, each with its
// own slot of tickets in 0 .. slots - 1.
int vitta_tam_slots() { return vitta::kTicketSlots; }

// bfloat16 g, x and dx, float32 attn, kern, dattn and dkern.  vec = 1: C %
// 8 == 0 and g, x, attn and dx 16-byte aligned (units of 8 channels, one
// launch; `slot` the stream's tickets); vec = 0: one channel a thread, two
// launches.  The caller decides and passes the same vec to
// vitta_tam_bwd_bf16_scratch_floats.
int vitta_tam_bwd_bf16(const void* g, const void* x, const float* attn,
                       const float* kern, void* dx, float* scratch,
                       float* dattn, float* dkern, int N, int T, int P, int C,
                       int vec, int slot, void* stream) {
  if (bad_dims(N, T, P, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    if (C % 8 != 0 || !aligned16(g) || !aligned16(x) || !aligned16(attn) ||
        !aligned16(dx))
      return (int)cudaErrorMisalignedAddress;
    const PlanB16 q = plan_bf16(N, T, P, C, vitta::sm_count());
    if (q.blocks > 0x7fffffffLL || tickets_bf16(q, N) > vitta::kSlotTickets ||
        slot < 0 || slot >= vitta::kTicketSlots)
      return (int)cudaErrorInvalidValue;
    return launch_bwd_bf16(q, g, x, attn, kern, dx, scratch, dattn, dkern, N,
                           T, P, slot, s);
  }
  const Plan q = plan_for(N, T, P, C, false);
  if (q.npb > 65535 || (long long)N * q.nseg > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_bwd<float, __nv_bfloat16>(q, g, x, attn, kern, dx, scratch,
                                          dattn, dkern, N, T, P, C, s);
}

}  // extern "C"
