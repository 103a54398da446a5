// The port's own float32 matrix product for Hopper (sm_90a): one
// shared-memory tiled kernel on the tensor cores, with its epilogues and
// host-side launchers, shared by mlp.cu (the six products of the fused
// LayerNorm->MLP and of the MLP without it) and attention_proj.cu (the qkv
// and output projections of the projection-fused window attention and every
// product of their backward).
//
// gemm_tiles computes C = op(A) op(B) for row-major operands in one of two
// layouts each: "k-minor" (the contraction index is the contiguous one: an
// activation (M, K) as A, an nn.Linear weight (N, K) as B) or "k-major" (the
// contraction index is the row: B (K, N) for a cotangent times a weight, and
// both A (K, M) and B (K, N) for the weight gradients, which contract over
// the activation's rows).
//
// What bounds it: operations, 2MNK of them against (MK + NK + MN) floats.
// The products run on the tensor cores as mma.sync.m16n8k8 on tf32
// operands in split TF32 (tf32.cuh): each float32 operand x = hi + lo, and
// a b = lo*hi + hi*lo + hi*hi, float32 accuracy at three tensor-core
// products (one tf32 product keeps about three decimal digits, which
// MLP_TOL and MLP_BWD_TOL do not allow).  The split is made in registers as
// each fragment is loaded (splitting a slice once in shared memory, into hi
// and lo copies, was slower at every Swin shape on an H100).  The products
// of one slice, four k steps, go to fresh accumulators that are then added
// to the running sums with a float add, which rounds to nearest: the tensor
// cores add into their accumulator with truncation, at its scale, and
// summed in place over K = 4096 that bias took dx of the LayerNorm-MLP's
// backward to 3.9e-5 of its largest value on an H100, past MLP_BWD_TOL.  A block owns a BM x BN tile of C, each of its warps a
// WM x WN share of it in accumulator registers: 128 x 128 with 8 warps of
// 64 x 32 where such tiles fill the card twice, 64 x 64 with 4 warps of
// 32 x 32 otherwise (the late stages of Swin-B at one or two clips give few
// rows).  The K loop stages BK-deep slices of A and B with 16-byte
// cp.async copies, as they lie in device memory, into a ring of kGemmStages
// shared-memory slots, so that the next slices' copies are in flight while
// the tensor cores work on the current one.  A k-minor slice is stored
// [row][k] with a row stride of BK + 4 floats (36), a k-major one [k][row]
// with a stride of its width + 8 (136 or 72): the fragment loads of a warp
// then hit 32 different banks, a k-minor one by ldmatrix.  Zero fill
// (cp.async with a source size of 0) covers the ragged edges: any number
// of activation rows, and a K that is a multiple of 4 but not of BK.  Every
// other extent must be a multiple of 4 (16-byte rows).  Each lane stores
// two neighbouring columns of its accumulator tiles at once, through the
// epilogue.
//
// A weight gradient contracts over all rows of the activation (up to 50,176)
// into an output of few tiles.  The TPU kernels add it up in an output block
// that their sequential grid revisits; here blockIdx.z splits the rows into
// chunks, each chunk writes its own partial product, and reduce_partials
// (reduce.cuh) adds the partials in a fixed order: enough blocks to fill the
// card, no atomics, the same result from run to run.
//
// Sums run over K terms in float32, slice by slice in k order, which is not
// the order of any library product: at K = 4096 two such sums of O(1) terms
// differ by some 1e-5 of the output's scale.
//
// A backward that holds a weight gradient and a product independent of it
// (attention_proj.cu) can run both as one gemm_pair launch, the block index
// picking the problem, and take the bias gradient, the column sums of the
// weight gradient's A, from the slices that product stages (EPI_PART).
//
// vitta_tpu_torch/tools/gemm_variants.py builds mlp.cu with other values of
// VITTA_GEMM_BK, VITTA_GEMM_STAGES and VITTA_GEMM_FRESH and times them;
// tools/pair_variants.py times a pair as one launch against two.
//
// The bfloat16 products of the LayerNorm-MLP run on wgmma instead
// (gemm_wgmma_bf16.cuh), which uses this header's epilogue codes and
// gelu_parts.

#pragma once
#include <cuda_runtime.h>

#include "launches.cuh"
#include "reduce.cuh"
#include "tf32.cuh"

#ifndef VITTA_GEMM_BK
#define VITTA_GEMM_BK 32
#endif
#ifndef VITTA_GEMM_STAGES
#define VITTA_GEMM_STAGES 3
#endif
#ifndef VITTA_GEMM_FRESH
#define VITTA_GEMM_FRESH 4
#endif

namespace vitta {

constexpr int kGemmBK = VITTA_GEMM_BK;          // k depth of a staged slice
constexpr int kGemmStages = VITTA_GEMM_STAGES;  // slices in the ring
static_assert(kGemmBK == 16 || kGemmBK == 32, "slices of 16 or 32 k");
static_assert(kGemmStages >= 2 && kGemmStages <= 4, "2 to 4 stages");
// k steps of eight summed in one fresh accumulator before it is added to
// the running sum: four, a whole slice of BK = 32
constexpr int kGemmFresh = VITTA_GEMM_FRESH;
static_assert(kGemmFresh == 1 || kGemmFresh == 2 || kGemmFresh == 4,
              "1, 2 or 4 k steps a fresh sum");
static_assert(kGemmBK / 8 % kGemmFresh == 0, "whole fresh sums a slice");

constexpr int EPI_BIAS = 0;   // C = acc + bias[col]
constexpr int EPI_GELU = 1;   // C = gelu(acc + bias[col]), S = its derivative
constexpr int EPI_MUL = 2;    // C = acc * aux[row][col]
constexpr int EPI_ADD = 3;    // C = acc + aux[row][col]   (aux may be null)
constexpr int EPI_RAW = 4;    // C[blockIdx.z] = acc       (partial products)
// C[z] = acc, each chunk's M x N partial product followed by one more row
// of M: the chunk's column sums of A (a k-major A, so the sums over the
// activation's rows that a bias gradient is); chunks M*N + M floats apart
constexpr int EPI_PART = 5;

__device__ __forceinline__ void gelu_parts(float h, float& a, float& s) {
  const float phi = 0.5f * (1.0f + erff(h * 0.7071067811865476f));
  a = h * phi;
  s = phi + h * expf(-0.5f * h * h) * 0.3989422804014327f;
}

// The shared-memory slice of an operand whose tile has R rows (of M or N):
// k-minor [R][BK] with stride BK + 4 (== 4 mod 32 for BK = 32, 20 for 16),
// k-major [BK][R] with stride R + 8 (== 8 mod 32).
template <int R, bool KM>
struct Slice {
  static constexpr int ld = KM ? R + 8 : kGemmBK + 4;
  static constexpr int floats = KM ? kGemmBK * ld : R * ld;
};

// Rows r0 .. r0 + R - 1 (of `rows`) and k0 .. k0 + BK - 1 (below kend) of
// an operand into its slice, asynchronously; zeros where either is past its
// end.  src[r * K + k] (k-minor) or src[k * rows + r] (k-major, rows a
// multiple of 4).
template <int R, bool KM, int kThreads>
__device__ __forceinline__ void stage_slice(float* dst,
                                            const float* __restrict__ src,
                                            int rows, int K, int r0, int k0,
                                            int kend, int tid) {
  constexpr int kChunks = R * kGemmBK / 4;   // 16-byte copies
  static_assert(kChunks % kThreads == 0, "whole copies per thread");
  constexpr int kPerLine = KM ? R / 4 : kGemmBK / 4;
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int line = idx / kPerLine, q = (idx % kPerLine) * 4;
    if (KM) {
      const bool ok = k0 + line < kend && r0 + q < rows;
      cp_async<16>(dst + line * Slice<R, KM>::ld + q,
                   ok ? src + (size_t)(k0 + line) * rows + r0 + q : src, ok);
    } else {
      const bool ok = r0 + line < rows && k0 + q < kend;
      cp_async<16>(dst + line * Slice<R, KM>::ld + q,
                   ok ? src + (size_t)(r0 + line) * K + k0 + q : src, ok);
    }
  }
}

// An SM holds one block of 8 warps at once, or two of 4: ptxas then gives
// the 128 x 128 tile 255 registers a thread and spills nothing (at two
// blocks of 8 warps it keeps to 128 and spills).
template <int BM, int BN, int WM, int WN>
struct GemmShape {
  static constexpr int warps = (BM / WM) * (BN / WN);
  static constexpr int threads = warps * 32;
  static constexpr int blocks = 8 / warps;   // per SM
};

// C (M, N) = sum over k in this block's chunk of K of a[m][k] * b[n][k], where
// a[m][k] is A[m*K + k] (A_KM false) or A[k*M + m] (A_KM true), and b[n][k]
// is B[n*K + k] or B[k*N + n] likewise.  The block is tile (bx, by) of C
// and chunk bz of K, the k range [bz*kchunk, min(K, (bz+1)*kchunk));
// kchunk is a multiple of BK.  The body of gemm_tiles (blockIdx's own tile)
// and of gemm_pair (two products in one launch).
template <int BM, int BN, int WM, int WN, bool A_KM, bool B_KM, int EPI>
__device__ __forceinline__ void gemm_tile(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ bias, const float* __restrict__ aux,
    float* __restrict__ Cout, float* __restrict__ Sout, int M, int N, int K,
    int kchunk, int bx, int by, int bz, float* smem) {
  constexpr int kThreads = GemmShape<BM, BN, WM, WN>::threads;
  constexpr int MI = WM / 16, NI = WN / 8;      // mma tiles of a warp
  using SA = Slice<BM, A_KM>;
  using SB = Slice<BN, B_KM>;
  constexpr int kStage = SA::floats + SB::floats;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "whole mma tiles, in pairs");
  static_assert(EPI != EPI_PART || A_KM, "column sums of a k-major A");

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;         // mma's g and t
  const int wm0 = (warp / (BN / WN)) * WM, wn0 = (warp % (BN / WN)) * WN;
  const int m0 = by * BM, n0 = bx * BN;
  const int kbeg = bz * kchunk;
  const int kend = kbeg + kchunk < K ? kbeg + kchunk : K;
  const int nk = (kend - kbeg + kGemmBK - 1) / kGemmBK;

  auto stage = [&](int slot, int k0) {
    float* As = smem + slot * kStage;
    stage_slice<BM, A_KM, kThreads>(As, A, M, K, m0, k0, kend, tid);
    stage_slice<BN, B_KM, kThreads>(As + SA::floats, B, N, K, n0, k0, kend,
                                    tid);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // EPI_PART: the column sums of A over the chunk, in the blocks of the
  // first column of tiles, each column cut into kSumParts runs of rows
  // that as many threads sum slice by slice
  constexpr int kSumParts = kThreads / BM;
  static_assert(EPI != EPI_PART || kThreads % BM == 0, "whole runs of rows");
  const bool sums = EPI == EPI_PART && bx == 0;
  const int scol = tid % BM, spart = tid / BM;
  float csum = 0.f;

#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < nk) stage(s, kbeg + s * kGemmBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kGemmStages - 2>();     // slice kt has landed
    __syncthreads();                      // and slice kt - 1 is read by all
    const int next = kt + kGemmStages - 1;
    if (next < nk) stage(next % kGemmStages, kbeg + next * kGemmBK);
    cp_async_commit();
    const float* As = smem + (kt % kGemmStages) * kStage;
    const float* Bs = As + SA::floats;
    if (EPI == EPI_PART && sums) {
      // this thread's rows of column scol of the slice, summed afresh
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kGemmBK / kSumParts; ++r)
        s += As[(spart * (kGemmBK / kSumParts) + r) * SA::ld + scol];
      csum += s;
    }
    // kGemmFresh k steps at a time into fresh sums of every tile of the
    // warp, k step by k step: the warp's B fragments, then one A fragment
    // at a time; a k-minor operand by ldmatrix (lane l addresses row l % 8
    // of its quarter, ql = l / 8), a k-major one element by element
    const int ql = lane >> 3, rl = lane & 7;
#pragma unroll
    for (int kp = 0; kp < kGemmBK / 8; kp += kGemmFresh) {
      float d[MI][NI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
#pragma unroll
      for (int kk = kp; kk < kp + kGemmFresh; ++kk) {
        FragB bf[NI];
#pragma unroll
        for (int j = 0; j < NI; j += 2) {
          if (B_KM) {
#pragma unroll
            for (int jj = j; jj < j + 2; ++jj) {
              const int n = wn0 + 8 * jj + g, k = 8 * kk + t;
              bf[jj] = frag_b(Bs[k * SB::ld + n], Bs[(k + 4) * SB::ld + n]);
            }
          } else {
            float r[4];
            ldmatrix_x4(r, Bs + (wn0 + 8 * j + rl + 8 * (ql >> 1)) * SB::ld +
                               8 * kk + 4 * (ql & 1));
            bf[j] = frag_b(r[0], r[1]);
            bf[j + 1] = frag_b(r[2], r[3]);
          }
        }
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          FragA af;
          if (A_KM) {
            const int m = wm0 + 16 * i + g, k = 8 * kk + t;
            af = frag_a(As[k * SA::ld + m], As[k * SA::ld + m + 8],
                        As[(k + 4) * SA::ld + m],
                        As[(k + 4) * SA::ld + m + 8]);
          } else {
            float r[4];
            ldmatrix_x4(r, As + (wm0 + 16 * i + rl + 8 * (ql & 1)) * SA::ld +
                               8 * kk + 4 * (ql >> 1));
            af = frag_a(r[0], r[1], r[2], r[3]);
          }
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_3xtf32(d[i][j], af, bf[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += d[i][j][e];
    }
  }

  // the epilogue on accumulator element pairs (row, col), (row, col + 1):
  // col is even and N a multiple of 4, so both lie inside or both outside
  if (EPI == EPI_RAW) Cout += (size_t)bz * M * N;
  if (EPI == EPI_PART) {
    Cout += (size_t)bz * ((size_t)M * N + M);
    if (sums) {   // uniform over the block: bx is the block's own
      cp_async_wait<0>();
      __syncthreads();          // every slice read; smem is free
      smem[tid] = csum;
      __syncthreads();
      if (tid < BM && m0 + tid < M) {
        float total = 0.f;
#pragma unroll
        for (int p = 0; p < kSumParts; ++p) total += smem[p * BM + tid];
        Cout[(size_t)M * N + m0 + tid] = total;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm0 + 16 * i + g + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = n0 + wn0 + 8 * j + 2 * t;
        if (col >= N) continue;
        float2 v = make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
        const size_t at = (size_t)row * N + col;
        if (EPI == EPI_BIAS || EPI == EPI_GELU) {
          const float2 bb = *reinterpret_cast<const float2*>(bias + col);
          v.x += bb.x, v.y += bb.y;
        }
        if (EPI == EPI_GELU) {
          float2 s;
          gelu_parts(v.x, v.x, s.x);
          gelu_parts(v.y, v.y, s.y);
          if (Sout != nullptr) *reinterpret_cast<float2*>(Sout + at) = s;
        }
        if (EPI == EPI_MUL || (EPI == EPI_ADD && aux != nullptr)) {
          const float2 x = *reinterpret_cast<const float2*>(aux + at);
          if (EPI == EPI_MUL)
            v.x *= x.x, v.y *= x.y;
          else
            v.x += x.x, v.y += x.y;
        }
        *reinterpret_cast<float2*>(Cout + at) = v;
      }
    }
}

template <int BM, int BN, int WM, int WN, bool A_KM, bool B_KM, int EPI>
__global__ void __launch_bounds__(GemmShape<BM, BN, WM, WN>::threads,
                                  GemmShape<BM, BN, WM, WN>::blocks)
gemm_tiles(const float* __restrict__ A, const float* __restrict__ B,
           const float* __restrict__ bias, const float* __restrict__ aux,
           float* __restrict__ Cout, float* __restrict__ Sout, int M, int N,
           int K, int kchunk) {
  extern __shared__ __align__(16) float smem[];
  gemm_tile<BM, BN, WM, WN, A_KM, B_KM, EPI>(A, B, bias, aux, Cout, Sout, M,
                                             N, K, kchunk, blockIdx.x,
                                             blockIdx.y, blockIdx.z, smem);
}

// One launch of gemm_tiles with its ring of slices in dynamic shared
// memory (above the 48 KB default: the opt-in, and the largest carve-out,
// which leaves room for as many blocks as the registers allow).
template <int BM, int BN, int WM, int WN, bool A_KM, bool B_KM, int EPI>
cudaError_t launch_tiles(dim3 grid, const float* A, const float* B,
                         const float* bias, const float* aux, float* Cout,
                         float* Sout, int M, int N, int K, int kchunk,
                         cudaStream_t stream) {
  const auto kernel = gemm_tiles<BM, BN, WM, WN, A_KM, B_KM, EPI>;
  constexpr size_t smem = sizeof(float) * kGemmStages *
                          (Slice<BM, A_KM>::floats + Slice<BN, B_KM>::floats);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, GemmShape<BM, BN, WM, WN>::threads, smem, stream>>>(
      A, B, bias, aux, Cout, Sout, M, N, K, kchunk);
  static const std::string name =
      template_name("gemm_tiles", BM, BN, WM, WN, A_KM, B_KM, EPI);
  count_launch(name.c_str());
  return cudaGetLastError();
}

// One product over the whole of K; the larger tile where it fills the card
// twice (one block of it an SM: a single wave would leave SMs idle behind
// its tail, which cost Swin-B's stage-2 and stage-4 products 8-15% on an
// H100), the smaller one otherwise.
template <bool B_KM, int EPI>
cudaError_t launch_gemm(const float* A, const float* B, const float* bias,
                        const float* aux, float* Cout, float* Sout, int M,
                        int N, int K, cudaStream_t stream) {
  const long long big = (long long)((M + 127) / 128) * ((N + 127) / 128);
  if (big >= 2LL * sm_count())
    return launch_tiles<128, 128, 64, 32, false, B_KM, EPI>(
        dim3((N + 127) / 128, (M + 127) / 128), A, B, bias, aux, Cout, Sout,
        M, N, K, K, stream);
  return launch_tiles<64, 64, 32, 32, false, B_KM, EPI>(
      dim3((N + 63) / 64, (M + 63) / 64), A, B, bias, aux, Cout, Sout, M, N,
      K, K, stream);
}

// How out (M, N) = A^T B with A (K, M) and B (K, N) is cut: the tile edge,
// the number of chunks of K and their length (a multiple of BK).  About two
// blocks per SM, chunks of at least 256 rows.
struct GradPlan {
  int tile, splits, kchunk;
};

inline GradPlan grad_plan(int M, int N, int K) {
  GradPlan p;
  p.tile = (M >= 128 && N >= 128) ? 128 : 64;
  const long long tiles =
      (long long)((M + p.tile - 1) / p.tile) * ((N + p.tile - 1) / p.tile);
  long long want = (2LL * sm_count() + tiles - 1) / tiles;
  const long long most = K / 256 > 1 ? K / 256 : 1;
  want = want < 1 ? 1 : (want > most ? most : want);
  p.kchunk = (int)(((K + want - 1) / want + kGemmBK - 1) / kGemmBK * kGemmBK);
  p.splits = (K + p.kchunk - 1) / p.kchunk;
  return p;
}

inline long long grad_partial_floats(int M, int N, int K) {
  const GradPlan p = grad_plan(M, N, K);
  return p.splits > 1 ? (long long)p.splits * M * N : 0;
}

// out (M, N) = A^T B, summed over the K rows in chunks and then over the
// chunks in order; `partial` holds grad_partial_floats(M, N, K).
inline cudaError_t launch_grad_gemm(const float* A, const float* B,
                                    float* out, float* partial, int M, int N,
                                    int K, cudaStream_t stream) {
  const GradPlan p = grad_plan(M, N, K);
  float* dst = p.splits > 1 ? partial : out;
  const dim3 grid((N + p.tile - 1) / p.tile, (M + p.tile - 1) / p.tile,
                  p.splits);
  cudaError_t e =
      p.tile == 128
          ? launch_tiles<128, 128, 64, 32, true, true, EPI_RAW>(
                grid, A, B, nullptr, nullptr, dst, nullptr, M, N, K,
                p.kchunk, stream)
          : launch_tiles<64, 64, 32, 32, true, true, EPI_RAW>(
                grid, A, B, nullptr, nullptr, dst, nullptr, M, N, K,
                p.kchunk, stream);
  if (e != cudaSuccess || p.splits == 1) return e;
  return launch_reduce_partials(partial, out, p.splits, (long long)M * N,
                                stream);
}

inline long long max2(long long a, long long b) { return a > b ? a : b; }

// ------------------------------------------------ a weight gradient and a
// row product in one launch, for a backward whose chain holds both
// (attention_proj.cu): dW = A^T B with its bias gradient, the column sums
// of A, beside a product that does not depend on it.

// Floats of the partials of a weight gradient with its column sums:
// grad_plan's chunks, M*N + M floats each (EPI_PART).
inline long long grad_sums_floats(int M, int N, int K) {
  return (long long)grad_plan(M, N, K).splits * ((long long)M * N + M);
}

// One product of a pair as gemm_pair's blocks see it: its operands and its
// blocks, gx x gy tiles of C times gz chunks of K.
struct GemmJob {
  const float* A;
  const float* B;
  const float* aux;
  float* C;
  int M, N, K, kchunk, gx, gy, gz;
  __host__ __device__ int blocks() const { return gx * gy * gz; }
};

// Two products of one tile shape in one launch: the row product R (an
// activation times a weight, k-minor A, k-major B, + aux) and the weight
// gradient G (k-major A and B, partials with column sums).  The block index
// picks the problem, G's blocks first where g_first: the blocks that run
// more slices start first.
template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(GemmShape<BM, BN, WM, WN>::threads,
                                  GemmShape<BM, BN, WM, WN>::blocks)
gemm_pair(const GemmJob r, const GemmJob gr, int g_first) {
  extern __shared__ __align__(16) float smem[];
  const int nr = r.blocks(), ng = gr.blocks();
  int b = blockIdx.x;
  const bool is_r = g_first ? b >= ng : b < nr;
  if (is_r) {
    b -= g_first ? ng : 0;
    gemm_tile<BM, BN, WM, WN, false, true, EPI_ADD>(
        r.A, r.B, nullptr, r.aux, r.C, nullptr, r.M, r.N, r.K, r.kchunk,
        b % r.gx, b / r.gx % r.gy, b / (r.gx * r.gy), smem);
  } else {
    b -= g_first ? 0 : nr;
    gemm_tile<BM, BN, WM, WN, true, true, EPI_PART>(
        gr.A, gr.B, nullptr, nullptr, gr.C, nullptr, gr.M, gr.N, gr.K,
        gr.kchunk, b % gr.gx, b / gr.gx % gr.gy, b / (gr.gx * gr.gy), smem);
  }
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch_pair(const GemmJob& r, const GemmJob& g,
                        cudaStream_t stream) {
  const auto kernel = gemm_pair<BM, BN, WM, WN>;
  constexpr int rows = Slice<BM, false>::floats + Slice<BN, true>::floats;
  constexpr int grad = Slice<BM, true>::floats + Slice<BN, true>::floats;
  constexpr size_t smem =
      sizeof(float) * kGemmStages * (rows > grad ? rows : grad);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<r.blocks() + g.blocks(), GemmShape<BM, BN, WM, WN>::threads, smem,
           stream>>>(r, g, g.kchunk > r.kchunk ? 1 : 0);
  static const std::string name = template_name("gemm_pair", BM, BN, WM, WN);
  count_launch(name.c_str());
  return cudaGetLastError();
}

// Whether a pair goes into one launch, for a row product (M, N) of depth K:
// as measured on an NVIDIA H100 80GB HBM3 at 700.00 W, at every Swin-B and
// Swin-T stage of 2 clips
// (tools/pair_variants.py; PERF.md keeps the table), one launch was faster
// for every row product no deeper than it is wide (g_att, K = N: 1-19%),
// and for the deeper ones (dx, K = 3N) except where the row product alone
// runs more than 1.5 waves of launch_gemm's small tile (stage 2, 2.2-3.0
// waves: 3-12% slower as one launch, at the weight gradient's large tile).
// The one shape this rule misjudges is Swin-T's stage 4 (0.6 waves), where
// one launch was 2% slower.
inline bool pair_grouped(int M, int N, int K) {
  if (K <= N) return true;
  const long long big = (long long)((M + 127) / 128) * ((N + 127) / 128);
  const long long small = (long long)((M + 63) / 64) * ((N + 63) / 64);
  return big >= 2LL * sm_count() || 2 * small <= 3LL * 2 * sm_count();
}

// out (M, N) = A B + aux (A (M, K), B (K, N) k-major, aux (M, N) or null),
// and partial = the weight gradient GA^T GB (GA (gk, gm), GB (gk, gn)) in
// grad_plan's chunks, each with GA's column sums, as EPI_PART lays them
// out; one launch where `grouped` (the tile of the weight gradient for
// both), two otherwise.  A null A or GA leaves that product out.  No
// partial is added up here: the caller's launch_reduce_sums does it.
inline cudaError_t launch_rows_and_grad(const float* A, const float* B,
                                        const float* aux, float* out, int M,
                                        int N, int K, const float* GA,
                                        const float* GB, float* partial,
                                        int gm, int gn, int gk, bool grouped,
                                        cudaStream_t stream) {
  const GradPlan p = grad_plan(gm, gn, gk);
  if (grouped && A != nullptr && GA != nullptr) {
    const int t = p.tile;
    const GemmJob r{A, B, aux, out, M, N, K, K, (N + t - 1) / t,
                    (M + t - 1) / t, 1};
    const GemmJob g{GA, GB, nullptr, partial, gm, gn, gk, p.kchunk,
                    (gn + t - 1) / t, (gm + t - 1) / t, p.splits};
    return t == 128 ? launch_pair<128, 128, 64, 32>(r, g, stream)
                    : launch_pair<64, 64, 32, 32>(r, g, stream);
  }
  cudaError_t e = cudaSuccess;
  if (A != nullptr)
    e = launch_gemm<true, EPI_ADD>(A, B, nullptr, aux, out, nullptr, M, N, K,
                                   stream);
  if (e != cudaSuccess || GA == nullptr) return e;
  const dim3 grid((gn + p.tile - 1) / p.tile, (gm + p.tile - 1) / p.tile,
                  p.splits);
  return p.tile == 128
             ? launch_tiles<128, 128, 64, 32, true, true, EPI_PART>(
                   grid, GA, GB, nullptr, nullptr, partial, nullptr, gm, gn,
                   gk, p.kchunk, stream)
             : launch_tiles<64, 64, 32, 32, true, true, EPI_PART>(
                   grid, GA, GB, nullptr, nullptr, partial, nullptr, gm, gn,
                   gk, p.kchunk, stream);
}

// Adds a weight gradient's partials (laid out by launch_rows_and_grad) to
// `sums`: dw (M, N) and db (M), either may be null.
inline bool add_grad_sums(PartialSums& sums, const float* partial, float* dw,
                          float* db, int M, int N, int K) {
  const GradPlan p = grad_plan(M, N, K);
  const long long stride = (long long)M * N + M;
  return sums.add(partial, stride, dw, p.splits, (long long)M * N) &&
         sums.add(partial + (long long)M * N, stride, db, p.splits, M);
}

}  // namespace vitta
