// Host image resizes for the data path: a half-pixel bilinear resize and a
// LANCZOS(3) resize that equals Pillow's Image.resize(..., Image.LANCZOS)
// bit for bit. Needs no JPEG library.
//
// Counterpart of the resizes in transplat_tpu/native/dataloader.cpp. Built
// with the host compiler at first use (transplat_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#include "parallel.h"

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

double sinc(double x) {
  if (x == 0.0) return 1.0;
  const double px = 3.14159265358979323846 * x;
  return std::sin(px) / px;
}

double lanczos3(double x) {
  if (x <= -3.0 || x >= 3.0) return 0.0;
  return sinc(x) * sinc(x / 3.0);
}

// Pillow's precompute_coeffs: for each output pixel the first input pixel
// (bounds[2 i]), the number of inputs (bounds[2 i + 1]) and ksize int32
// fixed-point coefficients. Returns ksize.
int precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds, std::vector<int>& kk) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double ss = 1.0 / filterscale;
  const double support = 3.0 * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  kk.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> prekk(ksize);

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    double ww = 0.0;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      const double w = lanczos3((x + xmin - center + 0.5) * ss);
      prekk[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) prekk[x] /= ww;
      const double v = prekk[x] * (1 << kPrecisionBits);
      kk[static_cast<size_t>(xx) * ksize + x] = static_cast<int>(v < 0 ? v - 0.5 : v + 0.5);
    }
    bounds[2 * xx] = xmin;
    bounds[2 * xx + 1] = xmax;
  }
  return ksize;
}

inline uint8_t clip8(int in) {
  const int v = in >> kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// in[n, h_in, w_in, 3] u8 -> out[n, h_out, w_out, 3] u8, half-pixel centres.
void tp_resize_bilinear_batch(const uint8_t* in, int n, int h_in, int w_in, uint8_t* out, int h_out, int w_out,
                              int num_threads) {
  const float sy = static_cast<float>(h_in) / h_out;
  const float sx = static_cast<float>(w_in) / w_out;
  tp::parallel_for(n, num_threads, [&](int i) {
    const uint8_t* src = in + static_cast<size_t>(i) * h_in * w_in * 3;
    uint8_t* dst = out + static_cast<size_t>(i) * h_out * w_out * 3;
    for (int y = 0; y < h_out; ++y) {
      float fy = (y + 0.5f) * sy - 0.5f;
      fy = std::max(0.0f, std::min(fy, static_cast<float>(h_in - 1)));
      const int y0 = static_cast<int>(fy);
      const int y1 = std::min(y0 + 1, h_in - 1);
      const float wy = fy - y0;
      for (int x = 0; x < w_out; ++x) {
        float fx = (x + 0.5f) * sx - 0.5f;
        fx = std::max(0.0f, std::min(fx, static_cast<float>(w_in - 1)));
        const int x0 = static_cast<int>(fx);
        const int x1 = std::min(x0 + 1, w_in - 1);
        const float wx = fx - x0;
        for (int c = 0; c < 3; ++c) {
          const float v00 = src[(y0 * w_in + x0) * 3 + c];
          const float v01 = src[(y0 * w_in + x1) * 3 + c];
          const float v10 = src[(y1 * w_in + x0) * 3 + c];
          const float v11 = src[(y1 * w_in + x1) * 3 + c];
          const float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx) + v11 * wy * wx;
          dst[(y * w_out + x) * 3 + c] = static_cast<uint8_t>(std::lround(std::max(0.f, std::min(255.f, v))));
        }
      }
    }
  });
}

// in[n, h_in, w_in, 3] u8 -> out[n, h_out, w_out, 3] u8, Pillow's LANCZOS:
// a horizontal pass into a uint8 intermediate, then a vertical pass, both
// with int32 fixed-point coefficients, as ImagingResample does.
void tp_resize_lanczos_batch(const uint8_t* in, int n, int h_in, int w_in, uint8_t* out, int h_out, int w_out,
                             int num_threads) {
  std::vector<int> xbounds, xkk, ybounds, ykk;
  const int xksize = precompute_coeffs(w_in, w_out, xbounds, xkk);
  precompute_coeffs(h_in, h_out, ybounds, ykk);
  const int yksize = static_cast<int>(ykk.size() / h_out);

  tp::parallel_for(n, num_threads, [&](int i) {
    const uint8_t* src = in + static_cast<size_t>(i) * h_in * w_in * 3;
    uint8_t* dst = out + static_cast<size_t>(i) * h_out * w_out * 3;
    // Horizontal pass. The channels go planar, padded by xksize zeros, so the
    // inner loop has a constant trip count (coefficients past xcount are 0).
    std::vector<uint8_t> tmp(static_cast<size_t>(h_in) * w_out * 3);
    std::vector<uint8_t> plane(static_cast<size_t>(3) * (w_in + xksize), 0);
    uint8_t* p0 = plane.data();
    uint8_t* p1 = p0 + (w_in + xksize);
    uint8_t* p2 = p1 + (w_in + xksize);
    for (int y = 0; y < h_in; ++y) {
      const uint8_t* srow = src + static_cast<size_t>(y) * w_in * 3;
      for (int x = 0; x < w_in; ++x) {
        p0[x] = srow[x * 3 + 0];
        p1[x] = srow[x * 3 + 1];
        p2[x] = srow[x * 3 + 2];
      }
      uint8_t* trow = tmp.data() + static_cast<size_t>(y) * w_out * 3;
      for (int x = 0; x < w_out; ++x) {
        const int xmin = xbounds[2 * x];
        const int* k = xkk.data() + static_cast<size_t>(x) * xksize;
        int ss0 = 1 << (kPrecisionBits - 1);
        int ss1 = ss0, ss2 = ss0;
        for (int xi = 0; xi < xksize; ++xi) {
          ss0 += p0[xmin + xi] * k[xi];
          ss1 += p1[xmin + xi] * k[xi];
          ss2 += p2[xmin + xi] * k[xi];
        }
        trow[x * 3 + 0] = clip8(ss0);
        trow[x * 3 + 1] = clip8(ss1);
        trow[x * 3 + 2] = clip8(ss2);
      }
    }
    // Vertical pass: whole contributing rows summed into an int32 row.
    std::vector<int> acc(static_cast<size_t>(w_out) * 3);
    for (int y = 0; y < h_out; ++y) {
      const int ymin = ybounds[2 * y];
      const int ycount = ybounds[2 * y + 1];
      const int* k = ykk.data() + static_cast<size_t>(y) * yksize;
      std::fill(acc.begin(), acc.end(), 1 << (kPrecisionBits - 1));
      for (int yi = 0; yi < ycount; ++yi) {
        const uint8_t* trow = tmp.data() + static_cast<size_t>(ymin + yi) * w_out * 3;
        const int kv = k[yi];
        int* a = acc.data();
        for (int j = 0; j < w_out * 3; ++j) a[j] += trow[j] * kv;
      }
      uint8_t* drow = dst + static_cast<size_t>(y) * w_out * 3;
      for (int j = 0; j < w_out * 3; ++j) drow[j] = clip8(acc[j]);
    }
  });
}

}  // extern "C"
