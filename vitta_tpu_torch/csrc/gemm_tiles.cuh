// The port's own float32 matrix product for Hopper (sm_90a): one
// shared-memory tiled kernel with its epilogues and host-side launchers,
// shared by mlp.cu (the six products of the fused LayerNorm->MLP) and
// attention_proj.cu (the qkv and output projections of the projection-fused
// window attention and every product of their backward).
//
// gemm_tiles computes C = op(A) op(B) for row-major operands in one of two
// layouts each: "k-minor" (the contraction index is the contiguous one: an
// activation (M, K) as A, an nn.Linear weight (N, K) as B) or "k-major" (the
// contraction index is the row: B (K, N) for a cotangent times a weight, and
// both A (K, M) and B (K, N) for the weight gradients, which contract over
// the activation's rows).  256 threads hold a BM x BN tile of C in registers
// (8x8 or 4x4 each); the K loop stages BK-deep slices of A and B through
// double-buffered shared memory, stored k-major so that a thread reads its
// rows and columns as 16-byte vectors (a k-major operand is copied as it
// lies, a k-minor one is transposed on the way in), and loads the next slice
// from device memory into registers while it multiplies the current one.  A
// thread's rows and columns are split into groups of four, half a tile
// apart, so that the lanes of a quarter-warp read distinct banks.  Tiles of
// 128x128x8 are used where they fill the card at least once, 64x64x16
// otherwise (the late stages of Swin-B at one or two clips give few rows).
// Any number of activation rows is taken; every other extent must be a
// multiple of 4 (16-byte rows).
//
// A weight gradient contracts over all rows of the activation (up to 50,176)
// into an output of few tiles.  The TPU kernels add it up in an output block
// that their sequential grid revisits; here blockIdx.z splits the rows into
// chunks, each chunk writes its own partial product, and reduce_partials
// (reduce.cuh) adds the partials in a fixed order: enough blocks to fill the
// card, no atomics, the same result from run to run.
//
// Sums run over K terms in float32 in tile order, which is not the order of
// any library product: at K = 4096 two such sums of O(1) terms differ by
// some 1e-5 of the output's scale.

#pragma once
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace vitta {

constexpr int kGemmThreads = 256;
constexpr int EPI_BIAS = 0;   // C = acc + bias[col]
constexpr int EPI_GELU = 1;   // C = gelu(acc + bias[col]), S = its derivative
constexpr int EPI_MUL = 2;    // C = acc * aux[row][col]
constexpr int EPI_ADD = 3;    // C = acc + aux[row][col]   (aux may be null)
constexpr int EPI_RAW = 4;    // C[blockIdx.z] = acc       (partial products)

__device__ __forceinline__ void gelu_parts(float h, float& a, float& s) {
  const float phi = 0.5f * (1.0f + erff(h * 0.7071067811865476f));
  a = h * phi;
  s = phi + h * expf(-0.5f * h * h) * 0.3989422804014327f;
}

// C (M, N) = sum over k in this block's chunk of K of a[m][k] * b[n][k], where
// a[m][k] is A[m*K + k] (A_KM false) or A[k*M + m] (A_KM true), and b[n][k]
// is B[n*K + k] or B[k*N + n] likewise.  blockIdx.z takes the k range
// [z*kchunk, min(K, (z+1)*kchunk)); kchunk is a multiple of BK.
template <int BM, int BN, int BK, int TM, int TN, bool A_KM, bool B_KM, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_tiles(const float* __restrict__ A, const float* __restrict__ B,
           const float* __restrict__ bias, const float* __restrict__ aux,
           float* __restrict__ Cout, float* __restrict__ Sout, int M, int N,
           int K, int kchunk) {
  static_assert(BM / TM == 16 && BN / TN == 16, "256 threads as 16 x 16");
  static_assert(BM * BK == 4 * kGemmThreads && BN * BK == 4 * kGemmThreads,
                "one 16-byte load per thread and operand");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "groups of four");
  constexpr int GM = TM / 4, GN = TN / 4;       // groups of four rows/columns
  constexpr int SM_ = BM / GM, SN_ = BN / GN;   // distance between groups
  constexpr int KQ = BK / 4;

  __shared__ __align__(16) float As[2][BK][BM + 4];
  __shared__ __align__(16) float Bs[2][BK][BN + 4];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = kbeg + kchunk < K ? kbeg + kchunk : K;
  // the one 16-byte load of this thread per operand and slice: a k-minor
  // operand gives four k of one row, a k-major one four rows of one k
  const int a_r = A_KM ? (tid % (BM / 4)) * 4 : tid / KQ;
  const int a_k = A_KM ? tid / (BM / 4) : (tid % KQ) * 4;
  const int b_r = B_KM ? (tid % (BN / 4)) * 4 : tid / KQ;
  const int b_k = B_KM ? tid / (BN / 4) : (tid % KQ) * 4;
  const bool a_ok = m0 + a_r < M, b_ok = n0 + b_r < N;   // M, N multiples of 4
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  auto load_a = [&](int k0) -> float4 {
    const int k = k0 + a_k;
    if (!a_ok || k >= kend) return zero4;
    return *reinterpret_cast<const float4*>(
        A_KM ? A + (size_t)k * M + m0 + a_r : A + (size_t)(m0 + a_r) * K + k);
  };
  auto load_b = [&](int k0) -> float4 {
    const int k = k0 + b_k;
    if (!b_ok || k >= kend) return zero4;
    return *reinterpret_cast<const float4*>(
        B_KM ? B + (size_t)k * N + n0 + b_r : B + (size_t)(n0 + b_r) * K + k);
  };
  auto store_a = [&](int buf, const float4& v) {
    if (A_KM) {
      *reinterpret_cast<float4*>(&As[buf][a_k][a_r]) = v;
    } else {
      As[buf][a_k + 0][a_r] = v.x;
      As[buf][a_k + 1][a_r] = v.y;
      As[buf][a_k + 2][a_r] = v.z;
      As[buf][a_k + 3][a_r] = v.w;
    }
  };
  auto store_b = [&](int buf, const float4& v) {
    if (B_KM) {
      *reinterpret_cast<float4*>(&Bs[buf][b_k][b_r]) = v;
    } else {
      Bs[buf][b_k + 0][b_r] = v.x;
      Bs[buf][b_k + 1][b_r] = v.y;
      Bs[buf][b_k + 2][b_r] = v.z;
      Bs[buf][b_k + 3][b_r] = v.w;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float4 ra = load_a(kbeg), rb = load_b(kbeg);
  store_a(0, ra);
  store_b(0, rb);
  __syncthreads();

  const int nk = (kend - kbeg + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      ra = load_a(kbeg + (kt + 1) * BK);
      rb = load_b(kbeg + (kt + 1) * BK);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float4 t =
            *reinterpret_cast<const float4*>(&As[cur][k][g * SM_ + ty * 4]);
        a[4 * g] = t.x, a[4 * g + 1] = t.y, a[4 * g + 2] = t.z, a[4 * g + 3] = t.w;
      }
#pragma unroll
      for (int g = 0; g < GN; ++g) {
        const float4 t =
            *reinterpret_cast<const float4*>(&Bs[cur][k][g * SN_ + tx * 4]);
        b[4 * g] = t.x, b[4 * g + 1] = t.y, b[4 * g + 2] = t.z, b[4 * g + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store_a(cur ^ 1, ra);
      store_b(cur ^ 1, rb);
    }
    __syncthreads();
  }

  if (EPI == EPI_RAW) Cout += (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + (i / 4) * SM_ + ty * 4 + (i % 4);
    if (row >= M) continue;
#pragma unroll
    for (int g = 0; g < GN; ++g) {
      const int col = n0 + g * SN_ + tx * 4;
      if (col >= N) continue;          // N is a multiple of 4
      float4 v = make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                             acc[i][4 * g + 2], acc[i][4 * g + 3]);
      if (EPI == EPI_BIAS || EPI == EPI_GELU) {
        const float4 bb = *reinterpret_cast<const float4*>(bias + col);
        v.x += bb.x, v.y += bb.y, v.z += bb.z, v.w += bb.w;
      }
      if (EPI == EPI_GELU) {
        float4 s;
        gelu_parts(v.x, v.x, s.x);
        gelu_parts(v.y, v.y, s.y);
        gelu_parts(v.z, v.z, s.z);
        gelu_parts(v.w, v.w, s.w);
        if (Sout != nullptr)
          *reinterpret_cast<float4*>(Sout + (size_t)row * N + col) = s;
      }
      if (EPI == EPI_MUL || (EPI == EPI_ADD && aux != nullptr)) {
        const float4 x =
            *reinterpret_cast<const float4*>(aux + (size_t)row * N + col);
        if (EPI == EPI_MUL)
          v.x *= x.x, v.y *= x.y, v.z *= x.z, v.w *= x.w;
        else
          v.x += x.x, v.y += x.y, v.z += x.z, v.w += x.w;
      }
      *reinterpret_cast<float4*>(Cout + (size_t)row * N + col) = v;
    }
  }
}

inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || count <= 0)
      count = 132;
  }
  return count;
}

// One product over the whole of K; the larger tile where it fills the card.
template <bool B_KM, int EPI>
cudaError_t launch_gemm(const float* A, const float* B, const float* bias,
                        const float* aux, float* Cout, float* Sout, int M,
                        int N, int K, cudaStream_t stream) {
  const long long big = (long long)((M + 127) / 128) * ((N + 127) / 128);
  if (big >= sm_count()) {
    const dim3 grid((N + 127) / 128, (M + 127) / 128);
    gemm_tiles<128, 128, 8, 8, 8, false, B_KM, EPI>
        <<<grid, kGemmThreads, 0, stream>>>(A, B, bias, aux, Cout, Sout, M, N,
                                            K, K);
  } else {
    const dim3 grid((N + 63) / 64, (M + 63) / 64);
    gemm_tiles<64, 64, 16, 4, 4, false, B_KM, EPI>
        <<<grid, kGemmThreads, 0, stream>>>(A, B, bias, aux, Cout, Sout, M, N,
                                            K, K);
  }
  return cudaGetLastError();
}

// How out (M, N) = A^T B with A (K, M) and B (K, N) is cut: the tile edge,
// the number of chunks of K and their length (a multiple of 16, so of both
// tiles' BK).  About two blocks per SM, chunks of at least 256 rows.
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
  p.kchunk = (int)(((K + want - 1) / want + 15) / 16 * 16);
  p.splits = (K + p.kchunk - 1) / p.kchunk;
  return p;
}

inline long long grad_partial_floats(int M, int N, int K) {
  const GradPlan p = grad_plan(M, N, K);
  return p.splits > 1 ? (long long)p.splits * M * N : 0;
}

// out (M, N) = A^T B, summed over the K rows in chunks and then over the
// chunks in order; `partial` holds grad_partial_floats(M, N, K).
inline cudaError_t launch_grad_gemm(const float* A, const float* B, float* out,
                             float* partial, int M, int N, int K,
                             cudaStream_t stream) {
  const GradPlan p = grad_plan(M, N, K);
  float* dst = p.splits > 1 ? partial : out;
  const dim3 grid((N + p.tile - 1) / p.tile, (M + p.tile - 1) / p.tile,
                  p.splits);
  if (p.tile == 128)
    gemm_tiles<128, 128, 8, 8, 8, true, true, EPI_RAW>
        <<<grid, kGemmThreads, 0, stream>>>(A, B, nullptr, nullptr, dst,
                                            nullptr, M, N, K, p.kchunk);
  else
    gemm_tiles<64, 64, 16, 4, 4, true, true, EPI_RAW>
        <<<grid, kGemmThreads, 0, stream>>>(A, B, nullptr, nullptr, dst,
                                            nullptr, M, N, K, p.kchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  return launch_reduce_partials(partial, out, p.splits,
                                       (long long)M * N, stream);
}

inline long long max2(long long a, long long b) { return a > b ? a : b; }

}  // namespace vitta
