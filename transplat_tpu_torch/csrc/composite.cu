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
// JAX oracle's rule (ops/rasterizer/reference.py): a Gaussian contributes
// while T_before >= 1e-4 and T_final multiplies only those factors. (The
// reference CUDA rasterizer stops one Gaussian earlier; that rule is not
// copied.)
//
// What bounds it on an H100: issuing the evaluations' instructions (an exp
// and ~20 other float32 operations per (pixel, entry), on the CUDA cores),
// and the grid's tail: 1,024 blocks of very uneven work. The bytes are small:
// each list entry's 32 + 4C feature bytes are read once per tile and reused
// by all 256 pixels from shared memory.
//
// Design: one block per (view, 16x16 tile), one thread per pixel; the block
// loads its list in batches of 256 entries (gathered by index from the
// depth-sorted features) into shared memory and every thread walks the batch
// in order. What the design does about the two limits:
// - Warp-level cull. A warp covers an 8x4 block of pixels (composite.cuh).
//   The thread that stages an entry also writes its warp mask: the warps
//   whose footprint meets the entry's conservative pixel rectangle (mean +-
//   radius, one pixel of margin). A warp walks only its entries (a ballot
//   over 32 positions, then their set bits): a pixel outside the rectangle
//   fails the radius test anyway, so no result changes, and every warp still
//   takes part in every barrier.
// - Longest list first, where a backward follows. Blocks then take their
//   tile through `order`, the cells sorted by list length (longest first), so
//   the longest tiles start in the first wave and the short ones fill the
//   tail; K4 reuses the order. A forward alone (serving) passes no order and
//   takes the cells as they come: there its gain is about the sort's cost.
// - Early exit: once no pixel of the tile has T >= 1e-4 the block stops
//   (__syncthreads_count before each batch); a warp whose pixels are all done
//   skips the rest of the batch.
// Output is written in raster order (B, H, W, C), cropped to the image. The
// TPU kernel's log-space transmittance cumsum on the MXU and its quadtree
// tile order were TPU workarounds and are not carried over: a thread simply
// multiplies.

#include "composite.cuh"

namespace {

using namespace composite;

// kTimed: the measuring instantiation (launched only by raster_report.py)
// also writes each block's start and end time, in ns, into block_times.
template <int C, bool kTimed>
__global__ void __launch_bounds__(kThreads)
composite_kernel(const float* __restrict__ gfeat, const float* __restrict__ colors,
                 const int* __restrict__ idx, const int2* __restrict__ ranges,
                 const int* __restrict__ order, const float* __restrict__ bg,
                 float* __restrict__ out, float* __restrict__ t_final, int g, int h, int w,
                 int ntx, int nty, long long* __restrict__ block_times) {
  __shared__ Batch<C> s;
  const long long t_start = kTimed ? global_ns() : 0;

  const int tiles = ntx * nty;
  const int cell = order != nullptr ? order[blockIdx.x] : (int)blockIdx.x;
  const int view = cell / tiles, tile = cell % tiles;
  const int lane = threadIdx.x, warp = lane / 32;
  const int ox = (tile % ntx) * kTile, oy = (tile / ntx) * kTile;
  const int2 local = pixel_of(lane);
  const int pix_x = ox + local.x, pix_y = oy + local.y;
  const float px = (float)pix_x, py = (float)pix_y;

  const int2 range = ranges[cell];
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
    stage<C>(s, feat, col, idx, start + lane, range.y, lane, (float)ox, (float)oy);
    __syncthreads();
    const int n = min(kThreads, range.y - start);
    for (int base = 0; base < n; base += 32) {
      if (__all_sync(0xffffffffu, done)) break;
      unsigned bits = warp_entries<C>(s, base, n, warp);
      while (bits) {
        const int j = base + __ffs(bits) - 1;
        bits &= bits - 1;
        if (done) continue;
        const Eval v = evaluate(s.geo0[j], s.geo1[j], px, py);
        if (!v.keep) continue;
        const float weight = v.alpha * t;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[ch] += weight * s.col[j * C + ch];
        t = t * (1.0f - v.alpha);
        done = t < kTransmittanceEps;
      }
    }
  }

  if (pix_x < w && pix_y < h) {
    float* o = out + (((long long)view * h + pix_y) * w + pix_x) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) o[ch] = acc[ch] + t * bg[view * C + ch];
    if (t_final != nullptr) t_final[((long long)view * h + pix_y) * w + pix_x] = t;
  }
  if (kTimed) {
    __syncthreads();
    if (lane == 0) {
      block_times[2 * (long long)cell] = t_start;
      block_times[2 * (long long)cell + 1] = global_ns();
    }
  }
}

template <int C>
int launch(const float* gfeat, const float* colors, const int* idx, const int* ranges,
           const int* order, const float* bg, float* out, float* t_final, int views, int g, int h,
           int w, int ntx, int nty, long long* block_times, cudaStream_t stream) {
  const int cells = views * ntx * nty;
  const int2* r = reinterpret_cast<const int2*>(ranges);
  if (block_times != nullptr)
    composite_kernel<C, true><<<cells, kThreads, 0, stream>>>(
        gfeat, colors, idx, r, order, bg, out, t_final, g, h, w, ntx, nty, block_times);
  else
    composite_kernel<C, false><<<cells, kThreads, 0, stream>>>(
        gfeat, colors, idx, r, order, bg, out, t_final, g, h, w, ntx, nty, nullptr);
  return (int)cudaGetLastError();
}

// Registers, static shared memory, local (spill) bytes and resident blocks
// per SM of the main-path instantiation for C channels.
template <int C>
int attributes(int* info) {
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, composite_kernel<C, false>);
  if (err) return err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], composite_kernel<C, false>,
                                                           kThreads, 0);
}

}  // namespace

#define TP_CHANNELS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

// order: null (the cells in their own order) or (views * ntx * nty,) int32, the cells in
// launch order (a permutation).
// block_times: null on the main path; else (views * ntx * nty, 2) int64 for the measuring launch.
extern "C" int tp_composite(const float* gfeat, const float* colors, const int* idx,
                            const int* ranges, const int* order, const float* bg, float* out,
                            float* t_final, int views, int g, int c, int h, int w, int ntx,
                            int nty, long long* block_times, void* stream) {
  if (views == 0 || ntx * nty == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define TP_CASE(N)                                                                             \
  case N:                                                                                      \
    return launch<N>(gfeat, colors, idx, ranges, order, bg, out, t_final, views, g, h, w, ntx, \
                     nty, block_times, s);
  switch (c) {
    TP_CHANNELS(TP_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TP_CASE
}

// info: registers, static shared bytes, local bytes, resident blocks per SM.
extern "C" int tp_composite_attributes(int c, int* info) {
#define TP_CASE(N) \
  case N: return attributes<N>(info);
  switch (c) {
    TP_CHANNELS(TP_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TP_CASE
}
