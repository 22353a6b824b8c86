// Tile compositing, forward (K3).
//
// Replaces: transplat_tpu/ops/rasterizer/pallas_composite.py
// `_composite_fwd_kernel` (and the background / raster-order epilogue of
// ops/rasterizer/api.py).
//
// Computes, per view and pixel, front to back over the pixel's tile list
// (depth order, from the binning):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy        (integer pixel centres)
//   alpha = min(0.99, opacity * exp(power)), kept only if power <= 0,
//           alpha >= 1/255 and dx^2 + dy^2 <= radius^2
//   colour += alpha * T * c_i, T *= (1 - alpha)       while T >= 1e-4
//   out = colour + T * background
// and, when the caller asks for it, the final transmittance T of every pixel
// (the residual the backward kernel, composite_bwd.cu, needs). This is the
// JAX oracle's rule (ops/rasterizer/reference.py): a Gaussian contributes while T_before >= 1e-4 and T_final multiplies only those
// factors. (The reference CUDA rasterizer stops one Gaussian earlier; that
// rule is not copied.)
//
// What bounds it on an H100: the exp and ~20 other float32 operations per
// (pixel, Gaussian) evaluation, on the CUDA cores (67 TFLOP/s), since the
// bytes are small: each list entry's 32 + 4C feature bytes are read once per
// tile and reused by all 256 pixels. The design keeps every read of a
// Gaussian in shared memory and stops a tile as soon as it saturates.
//
// Design: one block per (view, 16x16 tile), one thread per pixel. The block
// loads its list in batches of 256 Gaussians (gathered by index from the
// depth-sorted features) into shared memory; every thread then walks the
// batch in order. Once no pixel of the tile has T >= 1e-4 the block stops
// (checked with __syncthreads_count before each batch). Output is written in
// raster order (B, H, W, C), cropped to the image. The TPU kernel's
// log-space transmittance cumsum on the MXU and its quadtree tile order were
// TPU workarounds and are not carried over: a thread simply multiplies.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTransmittanceEps = 1e-4f;

template <int C>
__global__ void __launch_bounds__(kThreads)
composite_kernel(const float* __restrict__ gfeat, const float* __restrict__ colors,
                 const int* __restrict__ idx, const int2* __restrict__ ranges,
                 const float* __restrict__ bg, float* __restrict__ out,
                 float* __restrict__ t_final, int g, int h, int w, int ntx, int nty) {
  __shared__ float4 s_geo0[kThreads];  // mean x, mean y, conic a, conic b
  __shared__ float4 s_geo1[kThreads];  // conic c, radius, opacity, -
  __shared__ float s_col[kThreads * C];

  const int tile = blockIdx.x;
  const int view = blockIdx.y;
  const int lane = threadIdx.x;
  const int pix_x = (tile % ntx) * kTile + (lane % kTile);
  const int pix_y = (tile / ntx) * kTile + (lane / kTile);
  const float px = (float)pix_x, py = (float)pix_y;

  const int2 range = ranges[(long long)view * ntx * nty + tile];
  const float4* feat = reinterpret_cast<const float4*>(gfeat) + (long long)view * g * 2;
  const float* col = colors + (long long)view * g * C;

  float t = 1.0f;
  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
  bool done = false;

  for (int start = range.x; start < range.y; start += kThreads) {
    // Doubles as the barrier that protects shared memory from the last batch.
    if (__syncthreads_count(!done) == 0) break;
    const int k = start + lane;
    if (k < range.y) {
      const int gi = idx[k];
      s_geo0[lane] = feat[2 * (long long)gi];
      s_geo1[lane] = feat[2 * (long long)gi + 1];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) s_col[lane * C + ch] = col[(long long)gi * C + ch];
    }
    __syncthreads();
    const int n = min(kThreads, range.y - start);
    for (int j = 0; j < n && !done; ++j) {
      const float4 g0 = s_geo0[j];
      const float4 g1 = s_geo1[j];
      const float dx = px - g0.x;
      const float dy = py - g0.y;
      const float power = -0.5f * (g0.z * dx * dx + g1.x * dy * dy) - g0.w * dx * dy;
      const float alpha = fminf(kAlphaMax, g1.z * expf(power));
      if (!(power <= 0.0f && alpha >= kAlphaMin && dx * dx + dy * dy <= g1.y * g1.y)) continue;
      const float weight = alpha * t;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) acc[ch] += weight * s_col[j * C + ch];
      t = t * (1.0f - alpha);
      done = t < kTransmittanceEps;
    }
  }

  if (pix_x < w && pix_y < h) {
    float* o = out + (((long long)view * h + pix_y) * w + pix_x) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) o[ch] = acc[ch] + t * bg[view * C + ch];
    if (t_final != nullptr) t_final[((long long)view * h + pix_y) * w + pix_x] = t;
  }
}

template <int C>
int launch(const float* gfeat, const float* colors, const int* idx, const int* ranges,
           const float* bg, float* out, float* t_final, int views, int g, int h, int w, int ntx,
           int nty, cudaStream_t stream) {
  dim3 grid(ntx * nty, views);
  composite_kernel<C><<<grid, kThreads, 0, stream>>>(
      gfeat, colors, idx, reinterpret_cast<const int2*>(ranges), bg, out, t_final, g, h, w, ntx,
      nty);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tp_composite(const float* gfeat, const float* colors, const int* idx,
                            const int* ranges, const float* bg, float* out, float* t_final,
                            int views, int g, int c, int h, int w, int ntx, int nty,
                            void* stream) {
  if (views == 0 || ntx * nty == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 1: return launch<1>(gfeat, colors, idx, ranges, bg, out, t_final, views, g, h, w, ntx, nty, s);
    case 2: return launch<2>(gfeat, colors, idx, ranges, bg, out, t_final, views, g, h, w, ntx, nty, s);
    case 3: return launch<3>(gfeat, colors, idx, ranges, bg, out, t_final, views, g, h, w, ntx, nty, s);
    case 4: return launch<4>(gfeat, colors, idx, ranges, bg, out, t_final, views, g, h, w, ntx, nty, s);
    case 5: return launch<5>(gfeat, colors, idx, ranges, bg, out, t_final, views, g, h, w, ntx, nty, s);
    case 6: return launch<6>(gfeat, colors, idx, ranges, bg, out, t_final, views, g, h, w, ntx, nty, s);
    case 7: return launch<7>(gfeat, colors, idx, ranges, bg, out, t_final, views, g, h, w, ntx, nty, s);
    case 8: return launch<8>(gfeat, colors, idx, ranges, bg, out, t_final, views, g, h, w, ntx, nty, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
