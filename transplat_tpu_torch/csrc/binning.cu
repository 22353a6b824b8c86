// Tile binning (K1): per-tile Gaussian lists in depth order.
//
// Replaces: transplat_tpu/ops/rasterizer/pallas_binning.py `_bin_fwd_kernel`
// (with its feeders `cull_radii` and `chunk_bases`).
//
// Input: each view's Gaussians, already sorted by depth (dead ones last, with
// radius 0). Output: for every (view, tile) cell the depth-sorted ranks of the
// Gaussians whose cull rectangle covers it, in depth order, as one index list
// `idx` (cells in order, view-major) and each cell's [start, end) in it
// (`ranges`, (0, 0) for an empty cell). Nothing is dropped: no capacity.
//
// The TPU kernel routes every Gaussian into each covered cell's worklist with
// one-hot MXU matmuls, at offsets that XLA counts beforehand (`chunk_bases`):
// the number of earlier chunks' Gaussians covering the cell. The port does
// the same counting and placing with no sort, because the Gaussians are
// already in depth order: a pair's place in its cell's list is the number of
// earlier Gaussians covering the same cell. Three kernels:
//
//   1. bin_count: a block takes kChunk consecutive Gaussians of one view,
//      computes each one's tile rectangle under the exact per-axis cull of
//      `cull_radii` (float32, built with -fmad=false, term for term as
//      `_covers` evaluates it), adds its covered tiles into a shared-memory
//      histogram, writes table[view, tile, chunk] and each Gaussian's
//      rectangle packed in 8 bytes.
//   2. bin_scan: a warp per (view, tile) row turns the row into its
//      exclusive prefix over the chunks (what `chunk_bases` returns) and the
//      row's total; the last block to finish scans the row totals into
//      `ranges` and the number of pairs. The caller reads that number (the one
//      host read: `idx` needs its length) and allocates `idx`.
//   3. bin_place: a block reads its chunk's rectangles and places every pair:
//      row start + chunk prefix + the count of earlier Gaussians of the chunk
//      on the same tile. A warp owns 128 consecutive Gaussians; its cursor per
//      tile starts at the counts of the block's earlier warps, and it goes
//      through its Gaussians 32 at a time: each lane sets its bit in the mask
//      of every tile it covers, takes its place as the cursor plus the number
//      of lower lanes in that mask, and the tile's highest lane moves the
//      cursor on (in one pass where every lane covers at most 4 tiles, their
//      indices kept in registers; in three passes over the rectangles
//      otherwise). The block's pairs (up to kStaged) gather in shared memory,
//      tile after tile, and go out in runs of consecutive places. No keys are
//      written, nothing is sorted or gathered.
//
// Where a view has more tiles than one histogram holds (kMaxSliceTiles), the
// grid's third dimension cuts the tiles into slices, and each block counts
// and places the pairs of its slice only.
//
// What bounds it on an H100: device-memory bytes. The 32-byte rows are read
// once, idx (4 bytes a pair) and ranges (8 bytes a cell) written once; the
// count table (4 bytes per cell and chunk) and the packed rectangles (8 bytes
// a Gaussian) make a round trip through L2. What the design does about the
// rest, measured on an H100 (PERF.md): a thread computes all its Gaussians'
// rectangles before it counts any, so their long chains of dependent
// float operations overlap (one rectangle and its counting after another
// took 2.5x as long); the count writes the rectangles once instead of the
// place computing them again; the staged writes turn a 4-byte write per
// pair into runs (scattered, the writes took 11 of the place's 29 us); the
// one-pass placing of small rectangles took the place from 18.2 to 13.6 us.
//
// The packed rectangles also give the order of K2's deterministic mode
// (binning_bwd.cu): bin_gaussians keeps them with the lists.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kPerWarp = 128;                 // consecutive Gaussians a warp owns
constexpr int kChunk = kWarps * kPerWarp;     // Gaussians a block takes
constexpr int kMaxSliceTiles = 1024;          // tiles one block's histogram holds
constexpr int kStaged = 4096;                 // pairs a block of bin_place gathers before writing them
constexpr int kCountThreads = 512;            // bin_count's threads: two Gaussians each
constexpr unsigned kFull = 0xffffffffu;

// The inclusive tile rectangle (x0, y0, x1, y1) of one depth-sorted Gaussian,
// (1, 0, 0, 0) when it covers no tile. gfeat rows: mean x, mean y, conic a,
// b, c, radius, opacity, (unused).
__device__ __forceinline__ int4 gaussian_rect(float4 f0, float4 f1, int ntx, int nty, int tile) {
  const float mx = f0.x, my = f0.y, a = f0.z, b = f0.w, c = f1.x, r = f1.y, op = f1.z;
  const float det = fmaxf(a * c - b * b, 1e-20f);
  float tau = 2.0f * logf(fmaxf(op, 1e-20f) * 255.0f) + 1e-3f;
  tau = fmaxf(tau, 0.0f);
  float rx = fminf(sqrtf(fmaxf(tau * c, 0.0f) / det), r);
  float ry = fminf(sqrtf(fmaxf(tau * a, 0.0f) / det), r);
  const bool keep = (r > 0.0f) && (op * 255.0f >= 1.0f - 1e-3f);
  if (!keep) rx = ry = 0.0f;
  // A tile at pixel origin (x0, y0) is covered iff mx + rx >= x0,
  // mx - rx < x0 + tile (same in y) and rx > 0; solved for the tile index.
  if (rx > 0.0f) {
    // x / tile, as a product where tile is a power of two: the same value
    // rounded once either way.
    const float ft = (float)tile, inv = 1.0f / ft;
    const bool pow2 = (tile & (tile - 1)) == 0;
    auto over = [&](float x) { return pow2 ? x * inv : x / ft; };
    const float lox = floorf(over(mx - rx)), hix = floorf(over(mx + rx));
    const float loy = floorf(over(my - ry)), hiy = floorf(over(my + ry));
    // Clamped in float first, so the integer conversion stays in range.
    const int x0 = (int)fminf(fmaxf(lox, 0.0f), (float)ntx);
    const int x1 = (int)fmaxf(fminf(hix, (float)(ntx - 1)), -1.0f);
    const int y0 = (int)fminf(fmaxf(loy, 0.0f), (float)nty);
    const int y1 = (int)fmaxf(fminf(hiy, (float)(nty - 1)), -1.0f);
    if (x1 >= x0 && y1 >= y0) return make_int4(x0, y0, x1, y1);
  }
  return make_int4(1, 0, 0, 0);
}

// A rectangle in 8 bytes, 16 bits a coordinate (the grid is at most 65535
// tiles wide and high): (x0 | y0 << 16, x1 | y1 << 16).
__device__ __forceinline__ int2 pack_rect(int4 r) {
  return make_int2((int)((unsigned)r.x | ((unsigned)r.y << 16)), (int)((unsigned)r.z | ((unsigned)r.w << 16)));
}
__device__ __forceinline__ int4 unpack_rect(int2 p) {
  return make_int4(p.x & 0xffff, (unsigned)p.x >> 16, p.y & 0xffff, (unsigned)p.y >> 16);
}

// The block's view, chunk and tile slice [t0, t1), whose tiles lie in the
// tile rows ylo..yhi.
struct Slice {
  int view, chunk, t0, t1, ylo, yhi;
  __device__ Slice(int ntx, int tiles, int slice_tiles) {
    chunk = blockIdx.x;
    view = blockIdx.y;
    t0 = blockIdx.z * slice_tiles;
    t1 = min(tiles, t0 + slice_tiles);
    ylo = t0 / ntx;
    yhi = (t1 - 1) / ntx;
  }
};

// f(s) for every tile t = ty * ntx + tx of the rectangle inside the slice,
// in increasing t, with s = t - t0.
template <typename F>
__device__ __forceinline__ void for_tiles(int4 r, int ntx, const Slice& sl, F f) {
  if (r.z < r.x) return;
  const int ylo = max(r.y, sl.ylo), yhi = min(r.w, sl.yhi);
  for (int ty = ylo; ty <= yhi; ++ty) {
    const int row = ty * ntx;
    const int xlo = max(r.x, sl.t0 - row), xhi = min(r.z, sl.t1 - 1 - row);
    for (int tx = xlo; tx <= xhi; ++tx) f(row + tx - sl.t0);
  }
}

// Exclusive scan of one value per thread over the block; *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < kWarp; off <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == kWarp - 1) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    all += warp_sums[w];
  }
  *total = all;
  return before + incl - v;
}

// grid (chunks, views, slices), kCountThreads threads. Also writes each
// Gaussian's packed rectangle (the first slice's blocks) for bin_place.
__global__ void __launch_bounds__(kCountThreads)
    bin_count_kernel(const float* __restrict__ gfeat, int* __restrict__ table, int2* __restrict__ rects,
                     unsigned long long* __restrict__ aux, int g, int ntx, int nty, int tile, int chunks,
                     int slice_tiles) {
  __shared__ int hist[kMaxSliceTiles];
  const int tiles = ntx * nty;
  const Slice s(ntx, tiles, slice_tiles);
  const int width = s.t1 - s.t0;
  for (int i = threadIdx.x; i < width; i += kCountThreads) hist[i] = 0;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0) aux[1] = 0;  // bin_scan's block count
  __syncthreads();
  // A thread's Gaussians: their rows are loaded together, then counted.
  const long long view_row = (long long)s.view * g;
  const float4* rows = reinterpret_cast<const float4*>(gfeat);
  float4 f[2 * kChunk / kCountThreads];
#pragma unroll
  for (int k = 0; k < kChunk / kCountThreads; ++k) {
    const int rank = s.chunk * kChunk + k * kCountThreads + threadIdx.x;
    f[2 * k] = rank < g ? __ldg(rows + 2 * (view_row + rank)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    f[2 * k + 1] = rank < g ? __ldg(rows + 2 * (view_row + rank) + 1) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // All rectangles first: their long chains of dependent operations overlap.
  int4 r[kChunk / kCountThreads];
#pragma unroll
  for (int k = 0; k < kChunk / kCountThreads; ++k) r[k] = gaussian_rect(f[2 * k], f[2 * k + 1], ntx, nty, tile);
  int* h = hist;
#pragma unroll
  for (int k = 0; k < kChunk / kCountThreads; ++k) {
    const int rank = s.chunk * kChunk + k * kCountThreads + threadIdx.x;
    if (rank < g && blockIdx.z == 0) rects[view_row + rank] = pack_rect(r[k]);  // a zero row covers nothing
    for_tiles(r[k], ntx, s, [&](int t) { atomicAdd(h + t, 1); });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < width; i += kCountThreads)
    table[((long long)s.view * tiles + s.t0 + i) * chunks + s.chunk] = hist[i];
}

// A warp per (view, tile) row of the table: the row becomes its exclusive
// prefix over the chunks, its total goes to rowtot. A lane takes 8
// consecutive chunks at a time, loaded together. The last block to finish
// scans the totals into ranges ((0, 0) for an empty row) and aux[0], the
// number of pairs.
__global__ void __launch_bounds__(kThreads) bin_scan_kernel(int* __restrict__ table, int* rowtot,
                                                            int2* __restrict__ ranges, unsigned long long* aux,
                                                            long long rows, int chunks) {
  constexpr int kPer = 8;
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row < rows) {
    int* t = table + row * chunks;
    int carry = 0;
    for (int c0 = 0; c0 < chunks; c0 += kPer * kWarp) {
      int v[kPer];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = c0 + lane * kPer + j;
        v[j] = c < chunks ? t[c] : 0;
        sum += v[j];
      }
      int incl = sum;
      for (int off = 1; off < kWarp; off <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += up;
      }
      int run = carry + incl - sum;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = c0 + lane * kPer + j;
        if (c < chunks) t[c] = run;
        run += v[j];
      }
      carry += __shfl_sync(kFull, incl, kWarp - 1);
    }
    if (lane == 0) rowtot[row] = carry;
  }
  __shared__ bool last;
  __shared__ long long sums[kThreads];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(aux + 1, 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // Thread i takes the rows [i * per, (i + 1) * per).
  const long long per = (rows + kThreads - 1) / kThreads;
  const long long r0 = min(rows, threadIdx.x * per), r1 = min(rows, r0 + per);
  long long sum = 0;
  for (long long r = r0; r < r1; ++r) sum += __ldcg(rowtot + r);
  sums[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {  // inclusive scan of the threads' sums
    const long long up = threadIdx.x >= off ? sums[threadIdx.x - off] : 0;
    __syncthreads();
    sums[threadIdx.x] += up;
    __syncthreads();
  }
  long long start = sums[threadIdx.x] - sum;
  for (long long r = r0; r < r1; ++r) {
    const int n = __ldcg(rowtot + r);
    ranges[r] = n ? make_int2((int)start, (int)(start + n)) : make_int2(0, 0);
    start += n;
  }
  if (threadIdx.x == kThreads - 1) aux[0] = (unsigned long long)sums[kThreads - 1];
}

// grid (chunks, views, slices), kThreads threads; dynamic shared memory:
// the chunk's rectangles, a cursor and a lane mask per warp and tile, each
// tile's offset from a block position to a list position, and (where the
// block's pairs fit) the placed pairs before they are written out.
__global__ void __launch_bounds__(kThreads) bin_place_kernel(const int2* __restrict__ packed,
                                                             const int* __restrict__ bases,
                                                             const int2* __restrict__ ranges, int* __restrict__ idx,
                                                             int g, int ntx, int nty, int chunks, int slice_tiles) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  const int tiles = ntx * nty;
  const Slice s(ntx, tiles, slice_tiles);
  const int width = s.t1 - s.t0;
  int2* rects = reinterpret_cast<int2*>(smem);
  int* cursor = smem + 2 * kChunk;                                        // [kWarps][width]
  unsigned* mask = reinterpret_cast<unsigned*>(cursor + kWarps * width);  // [kWarps][width]
  int* offset = reinterpret_cast<int*>(mask + kWarps * width);            // [width]
  int* staged = offset + width;                                           // [kStaged] ranks
  unsigned short* staged_tile = reinterpret_cast<unsigned short*>(staged + kStaged);  // [kStaged]
  for (int i = threadIdx.x; i < kWarps * width; i += kThreads) cursor[i] = mask[i] = 0;
  __syncthreads();
  // Each warp's count per tile of its Gaussians (their rectangles loaded together).
  const long long view_row = (long long)s.view * g;
  int* my_cursor = cursor + warp * width;
  unsigned* my_mask = mask + warp * width;
  const int first = s.chunk * kChunk + warp * kPerWarp;  // the warp's first rank
  int2 own[kPerWarp / kWarp];
#pragma unroll
  for (int k = 0; k < kPerWarp / kWarp; ++k) {
    const int rank = first + k * kWarp + lane;
    own[k] = rank < g ? __ldg(packed + view_row + rank) : make_int2(1, 0);
  }
#pragma unroll
  for (int k = 0; k < kPerWarp / kWarp; ++k) {
    rects[warp * kPerWarp + k * kWarp + lane] = own[k];
    for_tiles(unpack_rect(own[k]), ntx, s, [&](int t) { atomicAdd(my_cursor + t, 1); });
  }
  __syncthreads();
  // Counts -> each warp's first block position on each tile (tiles in order,
  // then warps), and each tile's offset to its list positions. A thread
  // takes kTilesPerThread consecutive tiles.
  constexpr int kTilesPerThread = kMaxSliceTiles / kThreads;
  int n[kTilesPerThread], start[kTilesPerThread];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kTilesPerThread; ++j) {
    const int i = threadIdx.x * kTilesPerThread + j;
    n[j] = 0;
    if (i < width)
      for (int w = 0; w < kWarps; ++w) n[j] += cursor[w * width + i];
    mine += n[j];
    const long long cell = (long long)s.view * tiles + s.t0 + i;  // the list position of the chunk's first pair
    start[j] = n[j] > 0 ? ranges[cell].x + bases[cell * chunks + s.chunk] : 0;
  }
  int total;
  int run = block_exclusive_scan(mine, warp_sums, &total);
  const bool stage = total <= kStaged;
#pragma unroll
  for (int j = 0; j < kTilesPerThread; ++j) {
    const int i = threadIdx.x * kTilesPerThread + j;
    if (i < width && n[j] > 0) {
      offset[i] = start[j] - run;
      for (int w = 0; w < kWarps; ++w) {
        const int c = cursor[w * width + i];
        cursor[w * width + i] = run;
        run += c;
      }
    }
  }
  __syncthreads();
  // Place the warp's Gaussians 32 at a time: a lane's place on a tile is the
  // cursor plus the lanes below it on that tile.
  const unsigned lower = (1u << lane) - 1u;
  const bool whole_grid = s.t0 == 0 && s.t1 == tiles;
  auto put = [&](int at, int t, int rank) {
    if (stage) {
      staged[at] = rank;
      staged_tile[at] = (unsigned short)t;
    } else {
      idx[offset[t] + at] = rank;
    }
  };
  for (int k0 = 0; k0 < kPerWarp; k0 += kWarp) {
    if (first + k0 >= g) break;  // uniform over the warp
    const int4 r = unpack_rect(rects[warp * kPerWarp + k0 + lane]);
    const int rank = first + k0 + lane;
    const int wide = r.z - r.x + 1, area = r.z < r.x ? 0 : wide * (r.w - r.y + 1);
    if (whole_grid && __all_sync(kFull, area <= 4)) {
      // Every lane covers at most 4 tiles (1x1 .. 2x2, 1x4, 4x1): they stay in
      // registers, and the cursors move on after one pass.
      int t[4], moved[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int dx = wide == 1 ? 0 : wide == 2 ? (j & 1) : j, dy = wide == 1 ? j : wide == 2 ? (j >> 1) : 0;
        t[j] = (r.y + dy) * ntx + r.x + dx;
        if (j < area) atomicOr(my_mask + t[j], 1u << lane);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        moved[j] = -1;
        if (j < area) {
          const unsigned m = my_mask[t[j]];
          const int c = my_cursor[t[j]];
          put(c + __popc(m & lower), t[j], rank);
          if (31 - __clz(m) == lane) moved[j] = c + __popc(m);  // the tile's highest lane moves its cursor on
        }
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (moved[j] >= 0) {
          my_cursor[t[j]] = moved[j];
          my_mask[t[j]] = 0;
        }
      }
      __syncwarp();
      continue;
    }
    for_tiles(r, ntx, s, [&](int t) { atomicOr(my_mask + t, 1u << lane); });
    __syncwarp();
    for_tiles(r, ntx, s, [&](int t) { put(my_cursor[t] + __popc(my_mask[t] & lower), t, rank); });
    __syncwarp();
    for_tiles(r, ntx, s, [&](int t) {
      const unsigned m = my_mask[t];
      if (31 - __clz(m) == lane) {  // the tile's highest lane moves its cursor on
        my_cursor[t] += __popc(m);
        my_mask[t] = 0;
      }
    });
    __syncwarp();
  }
  if (!stage) return;
  // The block's pairs, tile after tile: consecutive threads write consecutive places.
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += kThreads) idx[offset[staged_tile[i]] + i] = staged[i];
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// The grid of bin_count and bin_place: (chunks, views, slices), and the tiles of a slice.
inline bool grid_of(long long views, int g, int ntx, int nty, int chunk, dim3* grid, int* slice_tiles) {
  if (chunk != kChunk || views <= 0 || views > 65535 || g <= 0 || ntx <= 0 || nty <= 0 || ntx > 65535 ||
      nty > 65535 || (long long)ntx * nty > 0x7fffffffLL)
    return false;
  const int tiles = ntx * nty;
  const int slices = (tiles + kMaxSliceTiles - 1) / kMaxSliceTiles;
  *slice_tiles = (tiles + slices - 1) / slices;
  *grid = dim3((unsigned)((g + kChunk - 1) / kChunk), (unsigned)views, (unsigned)slices);
  return true;
}

}  // namespace

// gfeat (views, g, 8) float32 depth-sorted rows -> table (views, ntx * nty,
// chunks) int32, chunks = ceil(g / chunk): the Gaussians of each chunk that
// cover each tile; rects (views, g) int2: each Gaussian's packed rectangle.
// Zeroes aux[1] for bin_scan. chunk must be kChunk.
extern "C" int tp_bin_count(const float* gfeat, int* table, int* rects, unsigned long long* aux, long long views,
                            int g, int ntx, int nty, int tile, int chunk, void* stream) {
  dim3 grid;
  int slice_tiles;
  if (!grid_of(views, g, ntx, nty, chunk, &grid, &slice_tiles)) return (int)cudaErrorInvalidValue;
  bin_count_kernel<<<grid, kCountThreads, 0, (cudaStream_t)stream>>>(
      gfeat, table, reinterpret_cast<int2*>(rects), aux, g, ntx, nty, tile, grid.x, slice_tiles);
  return (int)cudaGetLastError();
}

// table (rows, chunks) int32 counts, in place -> each row's exclusive prefix;
// rowtot (rows,) scratch; ranges (rows, 2) int32; aux[0] = the number of
// pairs. aux[1] must be 0 (bin_count sets it).
extern "C" int tp_bin_scan(int* table, int* rowtot, int* ranges, unsigned long long* aux, long long rows, int chunks,
                           void* stream) {
  if (rows <= 0 || chunks <= 0) return (int)cudaErrorInvalidValue;
  bin_scan_kernel<<<blocks_for(rows, kWarps), kThreads, 0, (cudaStream_t)stream>>>(
      table, rowtot, reinterpret_cast<int2*>(ranges), aux, rows, chunks);
  return (int)cudaGetLastError();
}

// rects from tp_bin_count, bases (views, tiles, chunks) and ranges from
// tp_bin_scan -> idx (number of pairs,) int32: each pair's depth-sorted rank.
extern "C" int tp_bin_place(const int* rects, const int* bases, const int* ranges, int* idx, long long views, int g,
                            int ntx, int nty, int chunk, void* stream) {
  dim3 grid;
  int slice_tiles;
  if (!grid_of(views, g, ntx, nty, chunk, &grid, &slice_tiles)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kChunk * sizeof(int2) + (size_t)(2 * kWarps + 1) * slice_tiles * sizeof(int) +
                      (size_t)kStaged * (sizeof(int) + sizeof(unsigned short));
  const cudaError_t err =
      cudaFuncSetAttribute(bin_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bin_place_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const int2*>(rects), bases, reinterpret_cast<const int2*>(ranges), idx, g, ntx, nty, grid.x,
      slice_tiles);
  return (int)cudaGetLastError();
}
