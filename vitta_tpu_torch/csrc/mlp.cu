// Fused LayerNorm -> MLP forward for Video Swin, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of vitta_tpu/ops/pallas_mlp.py:
//   _lnmlp_fwd_kernel (:303) and its pipelined form (:386), launched by
//   _pallas_lnmlp_fwd (:523).
//
// What it computes, on x (M, C) with the weights in torch.nn.Linear layout
// (w1 (F, C), w2 (C, F)):
//   y = LayerNorm(x) * gamma + beta          one-pass float32 statistics
//   h = y w1^T + b1
//   a = h * Phi(h)                           exact GELU, erff
//   o = a w2^T + b2
// and returns o and y (the norm2 tap reads y); on request also a and
// s = Phi(h) + h * phi(h), the GELU derivative, which a backward reads.
//
// What bounds it: float32 operations, 4*M*C*F of them, against 12*M*C bytes
// of x, y and o plus the weights.  Both matrix products are part of the TPU
// kernel's body, so they are written here by hand: one shared-memory tiled
// float32 product (gemm_nt below) serves both, with the bias and the GELU in
// its epilogue.  One wrapper call is three launches on one stream:
//   1. ln_rows (ln_rows.cuh): x -> y;
//   2. gemm_nt<GELU>: y, w1, b1 -> a (and s);
//   3. gemm_nt<BIAS>: a, w2, b2 -> o.
// The (M, F) activation a passes through device memory between 2 and 3; the
// TPU kernel keeps it in VMEM, and keeping it in shared memory here is left
// to the tuning of this kernel.
//
// gemm_nt computes C = A B^T for A (M, K) and B (N, K), both with K
// contiguous, which is what activations times a Linear weight are.  256
// threads hold a BM x BN tile of C in registers (8x8 or 4x4 each); the K
// loop stages BK-deep slices of A and B through double-buffered shared
// memory, stored k-major so that a thread reads its rows and columns as
// 16-byte vectors, and loads the next slice from device memory into
// registers while it multiplies the current one.  A thread's rows and
// columns are split into groups of four, half a tile apart, so that the
// lanes of a quarter-warp read distinct banks.  Tiles of 128x128x8 are
// used where they fill the card at least once, 64x64x16 otherwise (the
// late stages of Swin-B at one or two clips give few rows).  Any M is
// taken; C and F must be multiples of 4 (16-byte rows).
//
// Sums run over K = C or F = 4C terms in float32 in tile order, which is not
// the order of any library product: at K = 4096 two such sums of O(1) terms
// differ by some 1e-5 of the output's scale.

#include <cuda_runtime.h>

#include "ln_rows.cuh"

namespace {

constexpr int kGemmThreads = 256;
constexpr int EPI_BIAS = 0;
constexpr int EPI_GELU = 1;

__device__ __forceinline__ void gelu_parts(float h, float& a, float& s) {
  const float phi = 0.5f * (1.0f + erff(h * 0.7071067811865476f));
  a = h * phi;
  s = phi + h * expf(-0.5f * h * h) * 0.3989422804014327f;
}

template <int BM, int BN, int BK, int TM, int TN, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_nt(const float* __restrict__ A, const float* __restrict__ B,
        const float* __restrict__ bias, float* __restrict__ Cout,
        float* __restrict__ Sout, int M, int N, int K) {
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
  const int lrow = tid / KQ, lk = (tid % KQ) * 4;
  const bool a_ok = m0 + lrow < M, b_ok = n0 + lrow < N;
  const float* Ap = A + (size_t)(a_ok ? m0 + lrow : 0) * K + lk;
  const float* Bp = B + (size_t)(b_ok ? n0 + lrow : 0) * K + lk;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float4 ra = (a_ok && lk < K) ? *reinterpret_cast<const float4*>(Ap) : zero4;
  float4 rb = (b_ok && lk < K) ? *reinterpret_cast<const float4*>(Bp) : zero4;
  As[0][lk + 0][lrow] = ra.x;
  As[0][lk + 1][lrow] = ra.y;
  As[0][lk + 2][lrow] = ra.z;
  As[0][lk + 3][lrow] = ra.w;
  Bs[0][lk + 0][lrow] = rb.x;
  Bs[0][lk + 1][lrow] = rb.y;
  Bs[0][lk + 2][lrow] = rb.z;
  Bs[0][lk + 3][lrow] = rb.w;
  __syncthreads();

  const int nk = (K + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      const int k0 = (kt + 1) * BK;
      const bool k_ok = k0 + lk < K;
      ra = (a_ok && k_ok) ? *reinterpret_cast<const float4*>(Ap + k0) : zero4;
      rb = (b_ok && k_ok) ? *reinterpret_cast<const float4*>(Bp + k0) : zero4;
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
      const int nxt = cur ^ 1;
      As[nxt][lk + 0][lrow] = ra.x;
      As[nxt][lk + 1][lrow] = ra.y;
      As[nxt][lk + 2][lrow] = ra.z;
      As[nxt][lk + 3][lrow] = ra.w;
      Bs[nxt][lk + 0][lrow] = rb.x;
      Bs[nxt][lk + 1][lrow] = rb.y;
      Bs[nxt][lk + 2][lrow] = rb.z;
      Bs[nxt][lk + 3][lrow] = rb.w;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + (i / 4) * SM_ + ty * 4 + (i % 4);
    if (row >= M) continue;
#pragma unroll
    for (int g = 0; g < GN; ++g) {
      const int col = n0 + g * SN_ + tx * 4;
      if (col >= N) continue;          // N is a multiple of 4
      const float4 bb = *reinterpret_cast<const float4*>(bias + col);
      float4 v = make_float4(acc[i][4 * g] + bb.x, acc[i][4 * g + 1] + bb.y,
                             acc[i][4 * g + 2] + bb.z, acc[i][4 * g + 3] + bb.w);
      if (EPI == EPI_GELU) {
        float4 s;
        gelu_parts(v.x, v.x, s.x);
        gelu_parts(v.y, v.y, s.y);
        gelu_parts(v.z, v.z, s.z);
        gelu_parts(v.w, v.w, s.w);
        if (Sout != nullptr)
          *reinterpret_cast<float4*>(Sout + (size_t)row * N + col) = s;
      }
      *reinterpret_cast<float4*>(Cout + (size_t)row * N + col) = v;
    }
  }
}

int sm_count() {
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

template <int EPI>
cudaError_t launch_gemm(const float* A, const float* B, const float* bias,
                        float* Cout, float* Sout, int M, int N, int K,
                        cudaStream_t stream) {
  const long long big = (long long)((M + 127) / 128) * ((N + 127) / 128);
  if (big >= sm_count()) {
    const dim3 grid((N + 127) / 128, (M + 127) / 128);
    gemm_nt<128, 128, 8, 8, 8, EPI><<<grid, kGemmThreads, 0, stream>>>(
        A, B, bias, Cout, Sout, M, N, K);
  } else {
    const dim3 grid((N + 63) / 64, (M + 63) / 64);
    gemm_nt<64, 64, 16, 4, 4, EPI><<<grid, kGemmThreads, 0, stream>>>(
        A, B, bias, Cout, Sout, M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y, o: (m, c); w1 (f, c); w2 (c, f); a: (m, f), always written; s: (m, f)
// or null.
int vitta_lnmlp_fwd(const float* x, const float* gamma, const float* beta,
                    const float* w1, const float* b1, const float* w2,
                    const float* b2, float* y, float* a, float* s, float* o,
                    int m, int c, int f, float eps, void* stream) {
  if (m <= 0 || c <= 0 || f <= 0 || c % 4 != 0 || f % 4 != 0 ||
      (m + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = vitta::launch_ln_rows(x, gamma, beta, y, m, c, eps, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<EPI_GELU>(y, w1, b1, a, s, m, f, c, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_gemm<EPI_BIAS>(a, w2, b2, o, nullptr, m, c, f, st);
}

}  // extern "C"
