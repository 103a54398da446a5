// vitta_host — native host-side frame preprocessing.
//
// The reference's data plane is PIL + torchvision group transforms in
// DataLoader worker processes (models/tanet_models/transforms.py,
// corpus/basics.py:432-453).  This library provides the same pixel
// operations as tight C loops so a single host core can keep a TPU fed:
//
//  * resize_bilinear_u8 — convolution-based bilinear resampling with
//    scale-adaptive support, matching PIL Image.resize(BILINEAR)
//    semantics (triangle filter, antialias on downscale, fixed-point
//    accumulation) — the exactness requirement for eval parity
//    (SURVEY.md §7 "hard parts");
//  * crop_u8 — rectangular crop;
//  * normalize_f32 — fused (x[/255] - mean) / std, uint8 -> float32.
//
// Exposed with a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // PIL-style fixed point

inline double triangle_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Precompute convolution bounds+coefficients for one axis (in_size ->
// out_size), triangle filter with support widened by the scale factor
// when downscaling (antialias).
struct AxisCoeffs {
  int ksize;
  std::vector<int> bounds;    // (out_size, 2): xmin, xcount
  std::vector<int> coeffs;    // (out_size, ksize) fixed-point
};

AxisCoeffs compute_coeffs(int in_size, int out_size, int antialias) {
  const double support_base = 1.0;  // triangle
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = (antialias && scale > 1.0) ? scale : 1.0;
  double support = support_base * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  AxisCoeffs out;
  out.ksize = ksize;
  out.bounds.resize(out_size * 2);
  out.coeffs.resize(static_cast<size_t>(out_size) * ksize);
  std::vector<double> w(ksize);

  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      double v = triangle_filter((x + xmin - center + 0.5) * ss);
      w[x] = v;
      ww += v;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) w[x] /= ww;
    }
    for (int x = 0; x < xmax; ++x) {
      double c = w[x] * (1 << kPrecisionBits);
      out.coeffs[static_cast<size_t>(xx) * ksize + x] =
          static_cast<int>(c < 0 ? c - 0.5 : c + 0.5);
    }
    for (int x = xmax; x < ksize; ++x) {
      out.coeffs[static_cast<size_t>(xx) * ksize + x] = 0;
    }
    out.bounds[xx * 2 + 0] = xmin;
    out.bounds[xx * 2 + 1] = xmax;
  }
  return out;
}

// PIL-exact clip: 32-bit accumulator, arithmetic shift, saturate.
// Safe in int32: triangle weights are non-negative and normalized, so
// acc <= 255 * (1 << kPrecisionBits) + rounding < 2^30 (same bound PIL
// relies on with its int accumulators).
inline uint8_t clip8(int32_t v) {
  v >>= kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

}  // namespace

extern "C" {

// in:  (h, w, c) uint8 row-major; out: (oh, ow, c).
// antialias=1 -> PIL BILINEAR (scale-adaptive support);
// antialias=0 -> classic 2-tap bilinear (cv2/mmcv INTER_LINEAR semantics,
// used by the Swin/mmaction pipeline, transforms_backup.py:1162).
//
// Layout chosen for SIMD throughput on one core (the Prefetcher
// parallelizes across videos, so each call stays single-threaded):
// * int32 fixed-point accumulation (PIL's own precision) — twice the
//   vector lanes of the previous int64 form;
// * horizontal pass specialized for c==3 with per-channel register
//   accumulators over a contiguous tap window;
// * vertical pass restructured as per-tap row sweeps over a contiguous
//   int32 accumulator row — a textbook widening multiply-accumulate
//   the compiler auto-vectorizes (g++ -O3 -march=native).
namespace {

constexpr int32_t kHalf = 1 << (kPrecisionBits - 1);

// one scalar RGB output pixel (shared by the scalar pass and the
// vector pass's edge/tail pixels)
inline void hpass_rgb_pixel(const uint8_t* row, int xx, const AxisCoeffs& hc,
                            uint8_t* orow) {
  const int xcount = hc.bounds[xx * 2 + 1];
  const int* k = hc.coeffs.data() + static_cast<size_t>(xx) * hc.ksize;
  const uint8_t* p = row + hc.bounds[xx * 2] * 3;
  int32_t a0 = kHalf, a1 = kHalf, a2 = kHalf;
  switch (xcount) {
    case 4:
      a0 += p[9] * k[3]; a1 += p[10] * k[3]; a2 += p[11] * k[3];
      [[fallthrough]];
    case 3:
      a0 += p[6] * k[2]; a1 += p[7] * k[2]; a2 += p[8] * k[2];
      [[fallthrough]];
    case 2:
      a0 += p[0] * k[0] + p[3] * k[1];
      a1 += p[1] * k[0] + p[4] * k[1];
      a2 += p[2] * k[0] + p[5] * k[1];
      break;
    case 1:
      a0 += p[0] * k[0]; a1 += p[1] * k[0]; a2 += p[2] * k[0];
      break;
    default:
      for (int x = 0; x < xcount; ++x) {
        const int32_t kx = k[x];
        a0 += p[x * 3 + 0] * kx;
        a1 += p[x * 3 + 1] * kx;
        a2 += p[x * 3 + 2] * kx;
      }
  }
  orow[xx * 3 + 0] = clip8(a0);
  orow[xx * 3 + 1] = clip8(a1);
  orow[xx * 3 + 2] = clip8(a2);
}

// horizontal pass: (h, w, c) -> (h, ow, c), c == 3 fast path with the
// dominant 2/3/4-tap windows fully unrolled (upscale and mild downscale
// use tiny tap counts where loop overhead exceeds the arithmetic).
void hpass_rgb(const uint8_t* in, int h, int w, uint8_t* tmp, int ow,
               const AxisCoeffs& hc) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * w * 3;
    uint8_t* orow = tmp + static_cast<size_t>(y) * ow * 3;
    for (int xx = 0; xx < ow; ++xx) {
      hpass_rgb_pixel(row, xx, hc, orow);
    }
  }
}

#if defined(__AVX2__)
// Vectorized RGB horizontal pass — identical int32 fixed-point math to
// hpass_rgb (same kHalf rounding, same arithmetic-shift clip), just
// restructured as per-tap sweeps over 8 output pixels:
//  * one 32-bit gather per (tap, 8 pixels) loads each tap pixel's
//    r,g,b (+1 ignored byte); zero-padded taps contribute k==0;
//  * the vector region is limited to pixels whose every tap read —
//    padding included — stays strictly inside the input row, and ends
//    >=2 pixels before the row end so the 16-byte interleaved stores'
//    overhang is always rewritten (by the next iteration or the scalar
//    tail); edge pixels take the scalar path, so the output is
//    byte-identical to hpass_rgb.
void hpass_rgb_vec(const uint8_t* in, int h, int w, uint8_t* tmp, int ow,
                   const AxisCoeffs& hc) {
  const int ksize = hc.ksize;
  // per-frame precompute (reused across all h rows): tap-major
  // coefficients and byte base offsets
  std::vector<int32_t> kt(static_cast<size_t>(ksize) * ow);
  std::vector<int32_t> bo(ow);
  for (int xx = 0; xx < ow; ++xx) {
    bo[xx] = hc.bounds[xx * 2] * 3;
    for (int t = 0; t < ksize; ++t) {
      kt[static_cast<size_t>(t) * ow + xx] =
          hc.coeffs[static_cast<size_t>(xx) * hc.ksize + t];
    }
  }
  int vend = 0;  // first pixel whose widest gather could leave the row
  while (vend < ow && bo[vend] + 3 * (ksize - 1) + 4 <= 3 * w) ++vend;
  vend = std::min(vend, ow - 2);
  const int vw = vend < 8 ? 0 : (vend & ~7);

  const __m256i vzero = _mm256_setzero_si256();
  const __m256i v255 = _mm256_set1_epi32(255);
  const __m256i vmask = _mm256_set1_epi32(0xff);
  const __m256i vhalf = _mm256_set1_epi32(kHalf);
  // (r|g<<8|b<<16) x8 int32 -> 24 packed RGB bytes (12 per 128-bit lane)
  const __m256i shuf = _mm256_setr_epi8(
      0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14, -1, -1, -1, -1,
      0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14, -1, -1, -1, -1);

  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * w * 3;
    uint8_t* orow = tmp + static_cast<size_t>(y) * ow * 3;
    for (int xx = 0; xx < vw; xx += 8) {
      const __m256i off = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(bo.data() + xx));
      __m256i a0 = vhalf, a1 = vhalf, a2 = vhalf;
      for (int t = 0; t < ksize; ++t) {
        const __m256i g = _mm256_i32gather_epi32(
            reinterpret_cast<const int*>(row + 3 * t), off, 1);
        const __m256i k = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(
            kt.data() + static_cast<size_t>(t) * ow + xx));
        a0 = _mm256_add_epi32(
            a0, _mm256_mullo_epi32(_mm256_and_si256(g, vmask), k));
        a1 = _mm256_add_epi32(
            a1, _mm256_mullo_epi32(
                    _mm256_and_si256(_mm256_srli_epi32(g, 8), vmask), k));
        a2 = _mm256_add_epi32(
            a2, _mm256_mullo_epi32(
                    _mm256_and_si256(_mm256_srli_epi32(g, 16), vmask), k));
      }
      a0 = _mm256_min_epi32(
          _mm256_max_epi32(_mm256_srai_epi32(a0, kPrecisionBits), vzero),
          v255);
      a1 = _mm256_min_epi32(
          _mm256_max_epi32(_mm256_srai_epi32(a1, kPrecisionBits), vzero),
          v255);
      a2 = _mm256_min_epi32(
          _mm256_max_epi32(_mm256_srai_epi32(a2, kPrecisionBits), vzero),
          v255);
      const __m256i pix = _mm256_or_si256(
          a0, _mm256_or_si256(_mm256_slli_epi32(a1, 8),
                              _mm256_slli_epi32(a2, 16)));
      const __m256i packed = _mm256_shuffle_epi8(pix, shuf);
      _mm_storeu_si128(reinterpret_cast<__m128i*>(orow + xx * 3),
                       _mm256_castsi256_si128(packed));
      _mm_storeu_si128(reinterpret_cast<__m128i*>(orow + xx * 3 + 12),
                       _mm256_extracti128_si256(packed, 1));
    }
    for (int xx = vw; xx < ow; ++xx) {
      hpass_rgb_pixel(row, xx, hc, orow);
    }
  }
}
#endif  // __AVX2__

void hpass_generic(const uint8_t* in, int h, int w, int c, uint8_t* tmp,
                   int ow, const AxisCoeffs& hc) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * w * c;
    uint8_t* orow = tmp + static_cast<size_t>(y) * ow * c;
    for (int xx = 0; xx < ow; ++xx) {
      const int xmin = hc.bounds[xx * 2 + 0];
      const int xcount = hc.bounds[xx * 2 + 1];
      const int* k = hc.coeffs.data() + static_cast<size_t>(xx) * hc.ksize;
      for (int ch = 0; ch < c; ++ch) {
        int32_t acc = kHalf;
        for (int x = 0; x < xcount; ++x) {
          acc += row[(xmin + x) * c + ch] * k[x];
        }
        orow[xx * c + ch] = clip8(acc);
      }
    }
  }
}

// vertical pass: (h, ow, c) -> (oh, ow, c); one int32 accumulator row,
// swept once per tap in contiguous order (auto-vectorized widening MACs)
void vpass(const uint8_t* tmp, uint8_t* out, int oh, int rw,
           const AxisCoeffs& vc, int32_t* acc) {
  for (int yy = 0; yy < oh; ++yy) {
    const int ymin = vc.bounds[yy * 2 + 0];
    const int ycount = vc.bounds[yy * 2 + 1];
    const int* k = vc.coeffs.data() + static_cast<size_t>(yy) * vc.ksize;
    for (int xx = 0; xx < rw; ++xx) acc[xx] = kHalf;
    for (int y = 0; y < ycount; ++y) {
      const uint8_t* row = tmp + static_cast<size_t>(ymin + y) * rw;
      const int32_t ky = k[y];
      for (int xx = 0; xx < rw; ++xx) {
        acc[xx] += row[xx] * ky;
      }
    }
    uint8_t* orow = out + static_cast<size_t>(yy) * rw;
    for (int xx = 0; xx < rw; ++xx) {
      orow[xx] = clip8(acc[xx]);
    }
  }
}

void hpass(const uint8_t* in, int h, int w, int c, uint8_t* tmp, int ow,
           const AxisCoeffs& hc) {
  if (c == 3) {
#if defined(__AVX2__)
    hpass_rgb_vec(in, h, w, tmp, ow, hc);
#else
    hpass_rgb(in, h, w, tmp, ow, hc);
#endif
  } else {
    hpass_generic(in, h, w, c, tmp, ow, hc);
  }
}

void resize_one(const uint8_t* in, int h, int w, int c, uint8_t* out,
                int oh, int ow, const AxisCoeffs& hc, const AxisCoeffs& vc,
                uint8_t* tmp, int32_t* acc) {
  hpass(in, h, w, c, tmp, ow, hc);
  vpass(tmp, out, oh, ow * c, vc, acc);
}

}  // namespace

void resize_bilinear_u8(const uint8_t* in, int h, int w, int c,
                        uint8_t* out, int oh, int ow, int antialias) {
  AxisCoeffs hc = compute_coeffs(w, ow, antialias);
  AxisCoeffs vc = compute_coeffs(h, oh, antialias);
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * ow * c);
  std::vector<int32_t> acc(static_cast<size_t>(ow) * c);
  resize_one(in, h, w, c, out, oh, ow, hc, vc, tmp.data(), acc.data());
}

// batched variant: (n, h, w, c) -> (n, oh, ow, c); axis coefficients and
// scratch buffers computed once for the whole clip
void resize_bilinear_u8_batch(const uint8_t* in, int n, int h, int w, int c,
                              uint8_t* out, int oh, int ow, int antialias) {
  AxisCoeffs hc = compute_coeffs(w, ow, antialias);
  AxisCoeffs vc = compute_coeffs(h, oh, antialias);
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * ow * c);
  std::vector<int32_t> acc(static_cast<size_t>(ow) * c);
  for (int i = 0; i < n; ++i) {
    resize_one(in + static_cast<size_t>(i) * h * w * c, h, w, c,
               out + static_cast<size_t>(i) * oh * ow * c, oh, ow,
               hc, vc, tmp.data(), acc.data());
  }
}

// windowed resize: semantically resize (h, w) -> (oh, ow) then crop the
// output window (oy0, ox0, owh, oww) — but only the surviving pixels are
// ever computed.  Bit-identical to resize-then-crop (the per-output-pixel
// coefficients depend only on the pixel's coordinate in the full output
// grid, which is preserved here): the scale+center-crop eval pipeline
// keeps ~57% of a 256x341 resize, so fusing skips ~43% of the resample
// work.  Coefficient tables are still built for the full axes (cheap,
// O(out_size)); the horizontal pass runs only over the input rows the
// cropped vertical pass will touch.
void resize_bilinear_u8_window(const uint8_t* in, int n, int h, int w, int c,
                               uint8_t* out, int oh, int ow, int antialias,
                               int oy0, int ox0, int owh, int oww) {
  AxisCoeffs hc = compute_coeffs(w, ow, antialias);
  AxisCoeffs vc = compute_coeffs(h, oh, antialias);

  // slice the horizontal table to the output column window
  AxisCoeffs hcw;
  hcw.ksize = hc.ksize;
  hcw.bounds.assign(hc.bounds.begin() + static_cast<size_t>(ox0) * 2,
                    hc.bounds.begin() + static_cast<size_t>(ox0 + oww) * 2);
  hcw.coeffs.assign(
      hc.coeffs.begin() + static_cast<size_t>(ox0) * hc.ksize,
      hc.coeffs.begin() + static_cast<size_t>(ox0 + oww) * hc.ksize);

  // input-row span the cropped rows read, and the sliced vertical table
  // rebased onto it
  int ylo = h, yhi = 0;
  AxisCoeffs vcw;
  vcw.ksize = vc.ksize;
  vcw.bounds.resize(static_cast<size_t>(owh) * 2);
  vcw.coeffs.assign(
      vc.coeffs.begin() + static_cast<size_t>(oy0) * vc.ksize,
      vc.coeffs.begin() + static_cast<size_t>(oy0 + owh) * vc.ksize);
  for (int yy = 0; yy < owh; ++yy) {
    const int ymin = vc.bounds[(oy0 + yy) * 2 + 0];
    const int ycount = vc.bounds[(oy0 + yy) * 2 + 1];
    ylo = std::min(ylo, ymin);
    yhi = std::max(yhi, ymin + ycount);
    vcw.bounds[yy * 2 + 0] = ymin;  // rebased below once ylo is known
    vcw.bounds[yy * 2 + 1] = ycount;
  }
  if (ylo > yhi) { ylo = 0; yhi = 0; }
  for (int yy = 0; yy < owh; ++yy) vcw.bounds[yy * 2 + 0] -= ylo;

  const int hrows = yhi - ylo;
  std::vector<uint8_t> tmp(static_cast<size_t>(hrows) * oww * c);
  std::vector<int32_t> acc(static_cast<size_t>(oww) * c);
  for (int i = 0; i < n; ++i) {
    const uint8_t* src =
        in + (static_cast<size_t>(i) * h + ylo) * w * c;
    uint8_t* dst = out + static_cast<size_t>(i) * owh * oww * c;
    hpass(src, hrows, w, c, tmp.data(), oww, hcw);
    vpass(tmp.data(), dst, owh, oww * c, vcw, acc.data());
  }
}

// crop (n, h, w, c) -> (n, ch_, cw, c) at (y0, x0)
void crop_u8(const uint8_t* in, int n, int h, int w, int c,
             int y0, int x0, int ch_, int cw, uint8_t* out) {
  for (int i = 0; i < n; ++i) {
    const uint8_t* base = in + static_cast<size_t>(i) * h * w * c;
    uint8_t* obase = out + static_cast<size_t>(i) * ch_ * cw * c;
    for (int y = 0; y < ch_; ++y) {
      std::memcpy(obase + static_cast<size_t>(y) * cw * c,
                  base + (static_cast<size_t>(y0 + y) * w + x0) * c,
                  static_cast<size_t>(cw) * c);
    }
  }
}

// fused normalize: out = (in[/255] - mean) / std, per channel (c<=8)
void normalize_f32(const uint8_t* in, float* out, int64_t n_pixels, int c,
                   const float* mean, const float* std_, int div255) {
  float scale[8], offset[8];
  for (int ch = 0; ch < c; ++ch) {
    float inv = 1.0f / std_[ch];
    scale[ch] = (div255 ? inv / 255.0f : inv);
    offset[ch] = -mean[ch] * inv;
  }
  for (int64_t i = 0; i < n_pixels; ++i) {
    for (int ch = 0; ch < c; ++ch) {
      out[i * c + ch] = in[i * c + ch] * scale[ch] + offset[ch];
    }
  }
}

}  // extern "C"
