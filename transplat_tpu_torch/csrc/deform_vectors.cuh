// Shared by deform_vectors.cu (K7) and deform_vectors_bwd.cu (K8): the
// bilinear corner of one (sampling point, corner) pair, as one lane of a warp
// computes it.
//
// Rounding: px = loc_x * W - 0.5 and floor(px) are evaluated in float32 in
// that order (built with -fmad=false), exactly as the plain PyTorch version
// and the JAX `_bilinear_weights` do, so corner indices agree at fractional
// and boundary locations.

#pragma once

#include <cuda_runtime.h>

namespace deform_vectors {

constexpr int kWarp = 32;
constexpr int kPointsPerPass = kWarp / 4;  // 8 points x 4 corners fill a warp

struct Corner {
  float wx, wy;    // the point's fractions
  float weight;    // the corner's bilinear weight (not yet times aw)
  int index;       // iy * W + ix inside the map, -1 outside (zero padding)
};

// Corner `corner` (0: (y0, x0), 1: (y0, x0 + 1), 2: (y0 + 1, x0), 3: (y0 + 1,
// x0 + 1)) of the sample at (lx, ly) in [0, 1]^2 on an (h, w) map.
__device__ __forceinline__ Corner make_corner(float lx, float ly, int corner, int h, int w) {
  const float fw = (float)w, fh = (float)h;
  const float px = lx * fw - 0.5f;
  const float py = ly * fh - 0.5f;
  float x0 = floorf(px);
  float y0 = floorf(py);
  Corner c;
  c.wx = px - x0;
  c.wy = py - y0;
  // Far outside the map every corner is padding; clamping before the integer
  // conversion keeps it defined without changing which corners are inside.
  x0 = fminf(fmaxf(x0, -2.0f), fw + 1.0f);
  y0 = fminf(fmaxf(y0, -2.0f), fh + 1.0f);
  const int ix = (int)x0 + (corner & 1);
  const int iy = (int)y0 + (corner >> 1);
  const float ax = (corner & 1) ? c.wx : 1.0f - c.wx;
  const float ay = (corner >> 1) ? c.wy : 1.0f - c.wy;
  c.weight = ax * ay;
  c.index = (ix >= 0 && ix < w && iy >= 0 && iy < h) ? iy * w + ix : -1;
  return c;
}

}  // namespace deform_vectors
