// What the compositing kernels K3 (composite.cu) and K4 (composite_bwd.cu)
// share: the tile and warp layout, the staging of a batch of list entries with
// each entry's warp mask, and the forward's per-pixel evaluation. K4 repeats
// K3's walk; keeping both on this one code makes the live gate (T >= 1e-4)
// and the keep test flip on the same entries in both.
#pragma once

#include <cuda_runtime.h>

namespace composite {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;  // one thread per pixel of a tile
constexpr int kWarps = kThreads / 32;
// A warp covers a kFootW x kFootH block of the tile's pixels.
constexpr int kFootW = 8;
constexpr int kFootH = 32 / kFootW;
constexpr int kWarpsX = kTile / kFootW;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTransmittanceEps = 1e-4f;
// Beyond this a mean or radius takes no cull: its rectangle is the whole tile.
constexpr float kCullLimit = 1e6f;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Tile-local pixel of thread `lane` of the block: warp w covers the footprint
// at (w % kWarpsX, w / kWarpsX), its lanes in rows of kFootW.
__device__ __forceinline__ int2 pixel_of(int lane) {
  const int warp = lane / 32, l = lane % 32;
  return make_int2((warp % kWarpsX) * kFootW + l % kFootW, (warp / kWarpsX) * kFootH + l / kFootW);
}

// The warps of the tile at (ox, oy) whose footprint meets the entry's
// conservative pixel rectangle: floor(mean - radius) - 1 .. ceil(mean + radius)
// + 1 on each axis, clipped to the tile (bit w set for warp w). A pixel
// outside it fails dx^2 + dy^2 <= radius^2 in float32 for |mean|, radius
// below kCullLimit (the float error of that test is far below one pixel
// there); past the limit, or for a NaN, every warp is kept.
// ops/rasterizer/composite.py `entry_rects` / `warp_masks` is its plain version.
__device__ __forceinline__ unsigned warp_mask(float mx, float my, float radius, float ox,
                                              float oy) {
  const float r = fabsf(radius);  // the test squares it
  if (!(r < kCullLimit && fabsf(mx) < kCullLimit && fabsf(my) < kCullLimit))
    return (1u << kWarps) - 1u;
  const float x0 = fmaxf(floorf(mx - r) - 1.0f - ox, 0.0f);
  const float x1 = fminf(ceilf(mx + r) + 1.0f - ox, kTile - 1.0f);
  const float y0 = fmaxf(floorf(my - r) - 1.0f - oy, 0.0f);
  const float y1 = fminf(ceilf(my + r) + 1.0f - oy, kTile - 1.0f);
  unsigned mask = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float fx = (float)((w % kWarpsX) * kFootW), fy = (float)((w / kWarpsX) * kFootH);
    const bool meets = x0 <= fx + (kFootW - 1) && x1 >= fx && y0 <= fy + (kFootH - 1) && y1 >= fy;
    mask |= (unsigned)meets << w;
  }
  return mask;
}

// Shared memory of one batch of kThreads list entries.
template <int C>
struct Batch {
  float4 geo0[kThreads];  // mean x, mean y, conic a, conic b
  float4 geo1[kThreads];  // conic c, radius, opacity, -
  float col[kThreads * C];
  unsigned char mask[kThreads];  // warp_mask of each entry
};

// Thread `lane` stages entry k = start + lane of its tile's list (if it exists).
template <int C>
__device__ __forceinline__ void stage(Batch<C>& s, const float4* feat, const float* col,
                                      const int* idx, int k, int end, int lane, float ox,
                                      float oy) {
  if (k >= end) return;
  const int gi = idx[k];
  const float4 g0 = feat[2 * (long long)gi];
  const float4 g1 = feat[2 * (long long)gi + 1];
  s.geo0[lane] = g0;
  s.geo1[lane] = g1;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) s.col[lane * C + ch] = col[(long long)gi * C + ch];
  s.mask[lane] = (unsigned char)warp_mask(g0.x, g0.y, g1.y, ox, oy);
}

// The forward's evaluation of an entry at a pixel: unfused (-fmad=false), in
// this order, in both kernels.
struct Eval {
  float dx, dy, power, e, raw, alpha;
  bool keep;
};

__device__ __forceinline__ Eval evaluate(const float4 g0, const float4 g1, float px, float py) {
  Eval v;
  v.dx = px - g0.x;
  v.dy = py - g0.y;
  v.power = -0.5f * (g0.z * v.dx * v.dx + g1.x * v.dy * v.dy) - g0.w * v.dx * v.dy;
  v.e = expf(v.power);
  v.raw = g1.z * v.e;
  v.alpha = fminf(kAlphaMax, v.raw);
  v.keep = v.power <= 0.0f && v.alpha >= kAlphaMin && v.dx * v.dx + v.dy * v.dy <= g1.y * g1.y;
  return v;
}

// The entries of batch positions [base, base + 32) that warp `warp` must
// evaluate, as a warp-uniform bit set.
template <int C>
__device__ __forceinline__ unsigned warp_entries(const Batch<C>& s, int base, int n, int warp) {
  const int j = base + (threadIdx.x & 31);
  return __ballot_sync(0xffffffffu, j < n && ((s.mask[j] >> warp) & 1u));
}

}  // namespace composite
