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
// Layout: x, out, g and dx are (N, T, P, C) float32 and contiguous, with
// P = H*W: the channels-last activations of the port, with no copy.  attn
// is (N, T, C), the kernel weights (N, C, 3).
//
// What bounds it: memory.  The arithmetic is a few multiply-adds per
// element; at the ResNet-50 TAM sites one adapt step moves about 0.49 GB
// in the forward (read x, write out) and 0.73 GB in the backward (read g
// and x, write dx).  The design therefore reads and writes each element
// exactly once:
//  * one thread owns one (n, p, c) column and walks t with a three-deep
//    register window, so the TPU kernel's re-read of the neighbouring
//    frames (three frame reads per output frame) disappears;
//  * attn and K are indexed by c straight from their small tensors (the
//    TPU kernel broadcast them to per-lane rows only for its tiling);
//  * neighbouring threads own neighbouring channels, so every warp load
//    and store is one contiguous 128-byte line;
//  * the backward keeps its dK partial sums in registers over t, reduces
//    dattn and dK over the block's positions in shared memory in a fixed
//    order, writes one partial row per block, and a second small kernel
//    sums the partial rows in a fixed order.  No atomics: the result is
//    deterministic, and differs from a plain reduction only by the order
//    of float32 additions.  The partial rows add (T+3)/(T*kPosPerBlock)
//    of x's size to the backward's traffic.

#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kChanPerBlock = 32;   // one warp spans 32 channels
constexpr int kPosPerBlock = 8;     // 8 warps: 8 positions per block
constexpr int kReduceThreads = 256;

__global__ void tam_fwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ attn,
                               const float* __restrict__ kern,
                               float* __restrict__ out,
                               int T, int C, long long PC) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= PC) return;
  const int n = blockIdx.y;
  const int c = (int)(col % C);
  const float* kc = kern + ((long long)n * C + c) * 3;
  const float k0 = kc[0], k1 = kc[1], k2 = kc[2];
  const float* xs = x + (long long)n * T * PC + col;
  const float* as = attn + (long long)n * T * C + c;
  float* os = out + (long long)n * T * PC + col;

  float ym = 0.f;
  float y0 = as[0] * xs[0];
  for (int t = 0; t < T; ++t) {
    const float yp = (t + 1 < T) ? as[(t + 1) * C] * xs[(t + 1) * PC] : 0.f;
    os[t * PC] = k0 * ym + k1 * y0 + k2 * yp;
    ym = y0;
    y0 = yp;
  }
}

// grid (ceil(C/32), ceil(P/8), N), block (32, 8).  Shared memory holds one
// slot per thread for each of T dattn rows and 3 dK rows.
__global__ void tam_bwd_kernel(const float* __restrict__ g,
                               const float* __restrict__ x,
                               const float* __restrict__ attn,
                               const float* __restrict__ kern,
                               float* __restrict__ dx,
                               float* __restrict__ partial,
                               int T, int P, int C) {
  extern __shared__ float slots[];   // [(T + 3)][kPosPerBlock][kChanPerBlock]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kChanPerBlock + tx;
  const int p = blockIdx.y * kPosPerBlock + ty;
  const int n = blockIdx.z;
  const int rows = T + 3;
  const int slot = ty * kChanPerBlock + tx;
  constexpr int kRowStride = kPosPerBlock * kChanPerBlock;

  if (c < C && p < P) {
    const long long PC = (long long)P * C;
    const long long base = (long long)n * T * PC + (long long)p * C + c;
    const float* kc = kern + ((long long)n * C + c) * 3;
    const float k0 = kc[0], k1 = kc[1], k2 = kc[2];
    const float* as = attn + (long long)n * T * C + c;
    float dk0 = 0.f, dk1 = 0.f, dk2 = 0.f;
    float gm = 0.f;
    float g0 = g[base];
    for (int t = 0; t < T; ++t) {
      const long long off = base + t * PC;
      const float gp = (t + 1 < T) ? g[off + PC] : 0.f;
      const float xt = x[off];
      const float at = as[t * C];
      const float dy = k0 * gp + k1 * g0 + k2 * gm;
      dx[off] = at * dy;
      slots[t * kRowStride + slot] = dy * xt;
      const float yt = at * xt;
      dk0 += gp * yt;
      dk1 += g0 * yt;
      dk2 += gm * yt;
      gm = g0;
      g0 = gp;
    }
    slots[T * kRowStride + slot] = dk0;
    slots[(T + 1) * kRowStride + slot] = dk1;
    slots[(T + 2) * kRowStride + slot] = dk2;
  } else {
    for (int r = 0; r < rows; ++r) slots[r * kRowStride + slot] = 0.f;
  }
  __syncthreads();

  // Sum each (row, channel) over the block's positions, in a fixed order.
  const long long prow = ((long long)n * gridDim.y + blockIdx.y) * rows;
  for (int o = slot; o < rows * kChanPerBlock; o += kRowStride) {
    const int r = o / kChanPerBlock, cx = o % kChanPerBlock;
    const int cc = blockIdx.x * kChanPerBlock + cx;
    if (cc >= C) continue;
    float s = 0.f;
    for (int y = 0; y < kPosPerBlock; ++y)
      s += slots[r * kRowStride + y * kChanPerBlock + cx];
    partial[(prow + r) * C + cc] = s;
  }
}

// One thread per output element: dattn (N, T, C) and dK (N, C, 3) are the
// sums of the partial rows (N, nPB, T + 3, C) over the nPB position blocks.
__global__ void tam_bwd_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ dattn,
                                      float* __restrict__ dkern,
                                      int N, int nPB, int T, int C) {
  const int rows = T + 3;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)N * rows * C) return;
  const int c = (int)(idx % C);
  const int r = (int)((idx / C) % rows);
  const int n = (int)(idx / ((long long)rows * C));
  const float* src = partial + ((long long)n * nPB * rows + r) * C + c;
  const long long step = (long long)rows * C;
  float s = 0.f;
  for (int b = 0; b < nPB; ++b) s += src[b * step];
  if (r < T)
    dattn[((long long)n * T + r) * C + c] = s;
  else
    dkern[((long long)n * C + c) * 3 + (r - T)] = s;
}

int pos_blocks(int P) { return (P + kPosPerBlock - 1) / kPosPerBlock; }

size_t bwd_smem_bytes(int T) {
  return (size_t)(T + 3) * kPosPerBlock * kChanPerBlock * sizeof(float);
}

bool bad_dims(int N, int T, int P, int C) {
  return N <= 0 || T <= 0 || P <= 0 || C <= 0 || N > 65535;
}

}  // namespace

extern "C" {

// Floats of scratch the backward needs for its partial rows.
long long vitta_tam_bwd_scratch_floats(int N, int T, int P, int C) {
  return (long long)N * pos_blocks(P) * (T + 3) * C;
}

int vitta_tam_fwd(const float* x, const float* attn, const float* kern,
                  float* out, int N, int T, int P, int C, void* stream) {
  if (bad_dims(N, T, P, C)) return (int)cudaErrorInvalidValue;
  const long long PC = (long long)P * C;
  const dim3 grid((unsigned)((PC + kFwdThreads - 1) / kFwdThreads), N);
  tam_fwd_kernel<<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(
      x, attn, kern, out, T, C, PC);
  return (int)cudaGetLastError();
}

int vitta_tam_bwd(const float* g, const float* x, const float* attn,
                  const float* kern, float* dx, float* partial, float* dattn,
                  float* dkern, int N, int T, int P, int C, void* stream) {
  if (bad_dims(N, T, P, C) || pos_blocks(P) > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tam_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nPB = pos_blocks(P);
  const dim3 grid((C + kChanPerBlock - 1) / kChanPerBlock, nPB, N);
  const dim3 block(kChanPerBlock, kPosPerBlock);
  cudaStream_t s = (cudaStream_t)stream;
  tam_bwd_kernel<<<grid, block, smem, s>>>(g, x, attn, kern, dx, partial,
                                           T, P, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long outs = (long long)N * (T + 3) * C;
  tam_bwd_reduce_kernel<<<(unsigned)((outs + kReduceThreads - 1) / kReduceThreads),
                          kReduceThreads, 0, s>>>(partial, dattn, dkern, N,
                                                  nPB, T, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
