// Tile binning (K1): per-tile Gaussian lists in depth order.
//
// Replaces: transplat_tpu/ops/rasterizer/pallas_binning.py `_bin_fwd_kernel`
// (with its feeders `cull_radii` and `chunk_bases`).
//
// The TPU kernel routes every depth-sorted Gaussian's features into each
// covered cell's fixed-capacity worklist with one-hot MXU matmuls, because a
// TPU has no fast scatter. Hopper scatters and sorts well, so the port builds
// the same per-tile lists the classic way, with nothing dropped at capacity:
//
//   1. (torch.sort) Gaussians sorted by depth, stably, dead ones last;
//   2. bin_rects: each sorted Gaussian's tile rectangle under the exact
//      per-axis significance cull of `cull_radii` (same +1e-3 tau margin) and
//      its number of covered tiles; (torch.cumsum) gives every Gaussian its
//      offset into the pair list;
//   3. bin_emit: one (view * tiles + tile) key and one sorted-Gaussian index
//      per covered tile, written in depth order;
//   4. (torch.sort, stable) by key: each tile's run stays in depth order and
//      depth ties keep their original-index order, as JAX's stable sort does;
//   5. bin_ranges: each tile's [start, end) in the sorted list.
//
// What bounds it on an H100: device-memory bytes. bin_rects reads 28 bytes
// and writes 20 per Gaussian; bin_emit writes 8 bytes per pair; bin_ranges
// reads 4 and writes at most 8 per pair. Each is one thread per element with
// coalesced access; the two sorts are CUB radix sorts inside torch.sort.
//
// Cull arithmetic is float32 with -fmad=false, term for term as `cull_radii`
// and `_covers` evaluate it, so a looser or tighter rectangle never changes
// which pairs exist.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// gfeat rows: mean x, mean y, conic a, b, c, radius, opacity, (unused).
__global__ void bin_rects_kernel(const float* __restrict__ gfeat, int4* __restrict__ rects,
                                 int* __restrict__ counts, long long n, int ntx, int nty,
                                 int tile) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 f0 = reinterpret_cast<const float4*>(gfeat)[2 * i];
  const float4 f1 = reinterpret_cast<const float4*>(gfeat)[2 * i + 1];
  const float mx = f0.x, my = f0.y, a = f0.z, b = f0.w, c = f1.x, r = f1.y, op = f1.z;
  const float det = fmaxf(a * c - b * b, 1e-20f);
  float tau = 2.0f * logf(fmaxf(op, 1e-20f) * 255.0f) + 1e-3f;
  tau = fmaxf(tau, 0.0f);
  float rx = fminf(sqrtf(fmaxf(tau * c, 0.0f) / det), r);
  float ry = fminf(sqrtf(fmaxf(tau * a, 0.0f) / det), r);
  const bool keep = (r > 0.0f) && (op * 255.0f >= 1.0f - 1e-3f);
  if (!keep) rx = ry = 0.0f;
  int4 rect = make_int4(0, 0, -1, -1);
  int count = 0;
  // A tile at pixel origin (x0, y0) is covered iff mx + rx >= x0,
  // mx - rx < x0 + tile (same in y) and rx > 0; solved for the tile index.
  if (rx > 0.0f) {
    const float ft = (float)tile;
    const float lox = floorf((mx - rx) / ft), hix = floorf((mx + rx) / ft);
    const float loy = floorf((my - ry) / ft), hiy = floorf((my + ry) / ft);
    // Clamped in float first, so the integer conversion stays in range.
    const int x0 = (int)fminf(fmaxf(lox, 0.0f), (float)ntx);
    const int x1 = (int)fmaxf(fminf(hix, (float)(ntx - 1)), -1.0f);
    const int y0 = (int)fminf(fmaxf(loy, 0.0f), (float)nty);
    const int y1 = (int)fmaxf(fminf(hiy, (float)(nty - 1)), -1.0f);
    if (x1 >= x0 && y1 >= y0) {
      rect = make_int4(x0, y0, x1, y1);
      count = (x1 - x0 + 1) * (y1 - y0 + 1);
    }
  }
  rects[i] = rect;
  counts[i] = count;
}

__global__ void bin_emit_kernel(const int4* __restrict__ rects, const int* __restrict__ counts,
                                const long long* __restrict__ incl, int* __restrict__ keys,
                                int* __restrict__ vals, long long n, int g, int num_tiles,
                                int ntx) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int count = counts[i];
  if (count == 0) return;
  const int4 rect = rects[i];
  const int view = (int)(i / g);
  const int rank = (int)(i - (long long)view * g);
  long long off = incl[i] - count;
  const int base = view * num_tiles;
  for (int ty = rect.y; ty <= rect.w; ++ty) {
    for (int tx = rect.x; tx <= rect.z; ++tx) {
      keys[off] = base + ty * ntx + tx;
      vals[off] = rank;
      ++off;
    }
  }
}

__global__ void bin_ranges_kernel(const int* __restrict__ keys, int2* __restrict__ ranges,
                                  long long n) {
  const long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int key = keys[k];
  if (k == 0 || keys[k - 1] != key) ranges[key].x = (int)k;
  if (k == n - 1 || keys[k + 1] != key) ranges[key].y = (int)(k + 1);
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" int tp_bin_rects(const float* gfeat, int* rects, int* counts, long long n, int ntx,
                            int nty, int tile, void* stream) {
  if (n == 0) return 0;
  bin_rects_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      gfeat, reinterpret_cast<int4*>(rects), counts, n, ntx, nty, tile);
  return (int)cudaGetLastError();
}

extern "C" int tp_bin_emit(const int* rects, const int* counts, const long long* incl, int* keys,
                           int* vals, long long n, int g, int num_tiles, int ntx, void* stream) {
  if (n == 0) return 0;
  bin_emit_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(rects), counts, incl, keys, vals, n, g, num_tiles, ntx);
  return (int)cudaGetLastError();
}

extern "C" int tp_bin_ranges(const int* keys, int* ranges, long long n, void* stream) {
  if (n == 0) return 0;
  bin_ranges_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      keys, reinterpret_cast<int2*>(ranges), n);
  return (int)cudaGetLastError();
}
