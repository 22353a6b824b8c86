// Tile binning, backward (K2): list-entry gradients back to Gaussian rows.
//
// Replaces: transplat_tpu/ops/rasterizer/pallas_binning.py `_bin_bwd_kernel`
// (the backward of `bin_pallas`).
//
// Computes the transpose of the forward's routing (binning.cu): every
// tile-list entry k names one depth-sorted Gaussian idx[k] of the view its
// tile belongs to, and its gradient row d_pair[k, :] (from composite_bwd.cu)
// is added to that Gaussian's row:
//   d_feat[view(k), idx[k], :] += d_pair[k, :]
// A row holds the geometry gradient (8 columns) and the colour gradient (C
// columns, zero-padded to a multiple of 4), so it is 12 or 16 floats: three
// or four 16-byte vectors. The TPU kernel also zeroes the gradient of entries
// dropped at capacity; the port's lists have no capacity and drop nothing, so
// that rule has nothing to apply to here.
//
// What bounds it on an H100: device-memory bytes (d_pair and idx read once,
// d_feat written once; one add per value) and, in atomic mode, the rate at
// which L2 takes the scattered adds. The first design, one thread per value
// and a scalar float atomic per non-zero value, issued 11 atomics per entry
// into scattered rows, loaded idx[k] 11 times, divided by the row width in
// 64 bits and walked the views for every value: 2.7x its bytes bound on an
// H100 at the request's lists; this design reads 2.1x.
//
// Design, two modes:
//   * atomic (default): one thread per list entry. It reads its row as
//     16-byte vectors, leaves at once if the row is all zero (entries past a
//     tile's saturation), finds its view by a binary search over the views'
//     ends (held in shared memory), loads idx[k] once and adds each non-zero
//     vector with one 16-byte atomic (sm_90's atomicAdd(float4*),
//     red.global.add.v4.f32) into the zeroed output. The order of the adds,
//     and so the last bits, change from run to run.
//   * sorted (deterministic): each Gaussian's entries are added in list
//     order and its row written once, so the bits are the same on every run.
//     The order needs no sort, because K1's lists imply it: a Gaussian's
//     entries are the tiles of its cull rectangle, one each (the rectangles
//     bin_count packed, kept with the lists), and its tiles come in
//     increasing tile order in the view-major lists. So the Gaussians'
//     segments are the exclusive prefix of their rectangles' areas over
//     (view, Gaussian), and an entry of tile (tx, ty) takes the place
//     start + (ty - y0) * (x1 - x0 + 1) + (tx - x0) of its segment: exactly
//     the permutation a stable sort of the keys view * G + idx gives, with
//     no sort. Three kernels:
//       1. bin_bwd_offsets: a block per 2048 (view, Gaussian) rows: the
//          areas, their exclusive prefix inside the block, written with the
//          packed rectangle as one 16-byte record a row, and the block's
//          sum; block 0 also writes each cell's running list end (an empty
//          cell's range is (0, 0)), which tells the cell of an entry;
//       2. bin_bwd_perm: a block per 1024 list entries: every block scans
//          the (few) block sums in shared memory and writes its share of
//          the segments' global starts (`offsets`); each entry finds its
//          cell by a binary search of the running ends between its block's
//          first and last cells, gathers its Gaussian's record and goes to
//          its place: perm[place] = k (int32). Blocks of entries, not of
//          cells: a cell's list runs to thousands of entries in the middle
//          of a view, and a block per cell left those blocks alone at the end;
//       3. bin_bwd_sorted: a thread per (Gaussian, 16-byte vector of the
//          row) adds its segment's rows, read through perm as 16-byte
//          vectors, in segment order, four loads in flight, and writes the
//          vector once. Each column is summed in the same order as by a
//          thread per (Gaussian, column): the bits of the sorted route.
//     What bounds mode 3 on an H100: the bytes of d_pair (gathered rows, two
//     32-byte sectors each), perm and d_feat; modes 1 and 2 move the 8-byte
//     rectangles, idx and perm once more.

// Not carried over from the TPU kernel: the one-hot MXU contraction that
// un-routes the worklists chunk by chunk and the capacity windows. Hopper
// scatters with atomics.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxViews = 1024;

__device__ __forceinline__ bool nonzero(float4 v) {
  return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
}

__device__ __forceinline__ void atomic_add4(float* dst, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(dst), v);
#else
  atomicAdd(dst, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
#endif
}

// kVecs 16-byte vectors per row. view_max (views,) holds the largest list
// end among each view's tiles (0 for a view without entries).
template <int kVecs>
__global__ void __launch_bounds__(kThreads)
bin_bwd_atomic_kernel(const float4* __restrict__ d_pair, const int* __restrict__ idx,
                      const int* __restrict__ view_max, float* __restrict__ d_feat,
                      int n_pairs, int views, int g) {
  __shared__ int s_end[kMaxViews];
  // A running maximum makes the ends non-decreasing: a view without entries
  // then ends where the one before it ends, and no entry falls in it.
  if (threadIdx.x == 0) {
    int end = 0;
    for (int v = 0; v < views; ++v) s_end[v] = end = max(end, view_max[v]);
  }
  __syncthreads();
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_pairs) return;
  const float4* src = d_pair + (long long)k * kVecs;
  float4 v[kVecs];
  bool any = false;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    v[i] = __ldg(src + i);
    any |= nonzero(v[i]);
  }
  if (!any) return;  // past saturation: the whole row is 0
  int lo = 0, hi = views - 1;  // the first view whose entries end after k
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (k < s_end[mid]) hi = mid; else lo = mid + 1;
  }
  float* dst = d_feat + ((long long)lo * g + __ldg(idx + k)) * (4 * kVecs);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (nonzero(v[i])) atomic_add4(dst + 4 * i, v[i]);  // radius/pad and capped-alpha geometry are 0
  }
}

// The sorted mode's order (see the header). A packed rectangle is
// (x0 | y0 << 16, x1 | y1 << 16), (1, 0) for an empty one (binning.cu).
constexpr int kScanThreads = 512;
constexpr int kScanPer = 4;
constexpr int kScanRows = kScanThreads * kScanPer;  // (view, Gaussian) rows a block of bin_bwd_offsets takes
constexpr int kPermThreads = 256;
constexpr int kPermEntries = 4 * kPermThreads;        // list entries a block of bin_bwd_perm places
constexpr int kMaxScanBlocks = 48 * 1024;             // bin_bwd_perm scans the block sums in shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int4 unpack_rect(int2 p) {
  return make_int4(p.x & 0xffff, (unsigned)p.x >> 16, p.y & 0xffff, (unsigned)p.y >> 16);
}

// The number of tiles of a rectangle (the lists hold fewer than 2^31 pairs in all).
__device__ __forceinline__ int rect_area(int4 r) {
  return (r.z < r.x || r.w < r.y) ? 0 : (r.z - r.x + 1) * (r.w - r.y + 1);
}

// Exclusive scan of one value per thread over a block of kThreadsT threads
// under `op` (a sum, or a maximum from 0); *total gets the whole. warp_sums
// holds kThreadsT / 32 ints.
template <int kThreadsT, typename Op>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = op(incl, up);
  }
  const int excl_in_warp = __shfl_up_sync(kFull, incl, 1);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kThreadsT / 32; ++w) {
    before = w < warp ? op(before, warp_sums[w]) : before;
    all = op(all, warp_sums[w]);
  }
  __syncthreads();  // warp_sums may be reused
  *total = all;
  return lane ? op(before, excl_in_warp) : before;
}

__device__ __forceinline__ int add_op(int a, int b) { return a + b; }
__device__ __forceinline__ int max_op(int a, int b) { return max(a, b); }

// The block's rows go through shared memory, read and written by
// neighbouring threads at neighbouring rows; a thread scans kScanPer
// consecutive ones. rec[i] = (row i's packed rectangle, the areas of the
// block's rows before row i, 0), so that bin_bwd_perm gathers one 16-byte
// record an entry; block_sums[block] = the block's areas. Block 0 also
// writes cell_end[c], the largest list end among cells 0..c (an empty
// cell's range is (0, 0)): non-decreasing, and entry k lies in the first
// cell whose cell_end exceeds k.
__global__ void __launch_bounds__(kScanThreads)
bin_bwd_offsets_kernel(const int2* __restrict__ rects, const int2* __restrict__ ranges, int4* __restrict__ rec,
                       int* __restrict__ block_sums, int* __restrict__ cell_end, long long n_rows, long long cells) {
  __shared__ int2 packed[kScanRows];
  __shared__ int local[kScanRows];
  __shared__ int warp_sums[kScanThreads / 32];
  const long long row0 = (long long)blockIdx.x * kScanRows;
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) {
    const int i = j * kScanThreads + threadIdx.x;
    packed[i] = row0 + i < n_rows ? __ldg(rects + row0 + i) : make_int2(1, 0);
  }
  __syncthreads();
  int area[kScanPer];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) {
    area[j] = rect_area(unpack_rect(packed[threadIdx.x * kScanPer + j]));
    sum += area[j];
  }
  int total;
  int run = block_exclusive_scan<kScanThreads>(sum, warp_sums, &total, add_op);
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) {
    local[threadIdx.x * kScanPer + j] = run;
    run += area[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) {
    const int i = j * kScanThreads + threadIdx.x;
    if (row0 + i < n_rows) rec[row0 + i] = make_int4(packed[i].x, packed[i].y, local[i], 0);
  }
  if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
  if (blockIdx.x != 0) return;
  int carry = 0;
  for (long long c0 = 0; c0 < cells; c0 += kScanRows) {
    const long long c = c0 + (long long)threadIdx.x * kScanPer;
    int end[kScanPer];
    int m = 0;
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      end[j] = c + j < cells ? __ldg(ranges + c + j).y : 0;
      m = max(m, end[j]);
    }
    int all;
    int best = max(carry, block_exclusive_scan<kScanThreads>(m, warp_sums, &all, max_op));
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      best = max(best, end[j]);
      if (c + j < cells) cell_end[c + j] = best;
    }
    carry = max(carry, all);
  }
}

// The first cell in [lo, hi] whose cell_end exceeds k (cell_end[hi] > k),
// by a whole warp: each round its lanes probe 32 evenly spaced cells.
__device__ __forceinline__ long long warp_cell_of(const int* __restrict__ cell_end, long long k, long long lo,
                                                  long long hi) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {  // uniform over the warp
    const long long step = (hi - lo + 32) / 32;
    const long long probe = min(hi, lo + lane * step);
    const unsigned above = __ballot_sync(kFull, __ldg(cell_end + probe) > k);
    if (above & 1u) return lo;
    const int f = above ? __ffs(above) - 1 : 32;  // the first lane above k (cell_end is non-decreasing)
    const long long p_below = min(hi, lo + (long long)(f - 1) * step);
    hi = f < 32 ? min(hi, lo + (long long)f * step) : hi;
    lo = p_below + 1;
  }
  return lo;
}

// The first cell in [lo, hi] whose cell_end exceeds k (cell_end[hi] > k).
__device__ __forceinline__ long long cell_of(const int* __restrict__ cell_end, long long k, long long lo,
                                             long long hi) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(cell_end + mid) > k) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// grid: one block per kPermEntries list entries (and enough blocks for the
// offsets), kPermThreads threads; dynamic shared memory: the exclusive
// prefix of the n_blocks block sums. Block b writes offsets[i] for its
// rows_per_block rows i (offsets[n_rows] = the number of pairs) and puts
// each of its entries k at its place: perm[place] = k. An entry's cell is
// found by a binary search of cell_end between its block's first and last
// cells (found first, once). An entry whose tile lies outside its
// Gaussian's rectangle (lists that are not K1's own) is skipped rather than
// written out of its segment.
__global__ void __launch_bounds__(kPermThreads)
bin_bwd_perm_kernel(const int* __restrict__ idx, const int* __restrict__ cell_end, const int4* __restrict__ rec,
                    const int* __restrict__ block_sums, int* __restrict__ perm,
                    int* __restrict__ offsets, long long n_pairs, long long n_rows, long long cells,
                    long long rows_per_block, int n_blocks, int g, int ntx, int tiles) {
  extern __shared__ int prefix[];
  __shared__ int warp_sums[kPermThreads / 32];
  __shared__ long long span[2];
  const int per = (n_blocks + kPermThreads - 1) / kPermThreads;
  const int b0 = min(n_blocks, (int)threadIdx.x * per), b1 = min(n_blocks, b0 + per);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += __ldg(block_sums + b);
  int total;
  int run = block_exclusive_scan<kPermThreads>(sum, warp_sums, &total, add_op);
  for (int b = b0; b < b1; ++b) {
    prefix[b] = run;
    run += __ldg(block_sums + b);
  }
  const long long r0 = blockIdx.x * rows_per_block, r1 = min(n_rows + 1, r0 + rows_per_block);
  const long long k0 = (long long)blockIdx.x * kPermEntries, k1 = min(n_pairs, k0 + kPermEntries);
  if (threadIdx.x < 64 && k0 < k1) {  // warp 0: the block's first cell, warp 1: its last
    const long long c = warp_cell_of(cell_end, threadIdx.x < 32 ? k0 : k1 - 1, 0, cells - 1);
    if ((threadIdx.x & 31) == 0) span[threadIdx.x >> 5] = c;
  }
  __syncthreads();
  for (long long i = r0 + threadIdx.x; i < r1; i += kPermThreads)
    offsets[i] = i < n_rows ? __ldg(&rec[i].z) + prefix[i / kScanRows] : total;
  for (long long k = k0 + threadIdx.x; k < k1; k += kPermThreads) {
    const long long cell = cell_of(cell_end, k, span[0], span[1]);
    const long long view = cell / tiles;
    const int t = (int)(cell - view * tiles), tx = t % ntx, ty = t / ntx;
    const int gi = __ldg(idx + k);
    if ((unsigned)gi >= (unsigned)g) continue;
    const long long row = view * g + gi;
    const int4 g4 = __ldg(rec + row);
    const int4 r = unpack_rect(make_int2(g4.x, g4.y));
    const int dx = tx - r.x, dy = ty - r.y, wide = r.z - r.x + 1;
    if (dx < 0 || dx >= wide || dy < 0 || ty > r.w) continue;
    const long long place = (long long)g4.z + prefix[row / kScanRows] + (long long)dy * wide + dx;
    if (place < n_pairs) perm[place] = (int)k;
  }
}

// A thread per (Gaussian row, 16-byte vector): the segment's d_pair vectors
// added in segment order, four loads in flight; every vector of d_feat is
// written once.
template <int kVecs>
__global__ void __launch_bounds__(256)
bin_bwd_sorted_kernel(const float4* __restrict__ d_pair, const int* __restrict__ perm,
                      const int* __restrict__ offsets, float4* __restrict__ d_feat, long long n_rows,
                      long long n_pairs) {
  const long long t = blockIdx.x * 256LL + threadIdx.x;
  if (t >= n_rows * kVecs) return;
  const long long row = t / kVecs;
  const int vec = (int)(t - row * kVecs);
  const int s = __ldg(offsets + row);
  const int e = (int)min((long long)__ldg(offsets + row + 1), n_pairs);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto add = [&](int k) {
    if ((unsigned)k >= (unsigned long long)n_pairs) return;
    const float4 v = __ldg(d_pair + (long long)k * kVecs + vec);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  };
  int j = s;
  for (; j + 4 <= e; j += 4) {
    int k[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) k[u] = __ldg(perm + j + u);
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = (unsigned)k[u] < (unsigned long long)n_pairs ? __ldg(d_pair + (long long)k[u] * kVecs + vec)
                                                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc.x += v[u].x;
      acc.y += v[u].y;
      acc.z += v[u].z;
      acc.w += v[u].w;
    }
  }
  for (; j < e; ++j) add(__ldg(perm + j));
  d_feat[t] = acc;
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// d_feat (views * g, row) must arrive zeroed; row is 12 or 16 (16-byte
// aligned rows); view_max (views,) int32 holds each view's largest list end.
extern "C" int tp_bin_bwd(const float* d_pair, const int* idx, const int* view_max,
                          float* d_feat, long long n_pairs, int row, int views, int g,
                          void* stream) {
  if (n_pairs == 0) return 0;
  if (n_pairs >= (1LL << 31) || views < 1 || views > kMaxViews) return (int)cudaErrorInvalidValue;
  const unsigned blocks = blocks_for(n_pairs, kThreads);
  const float4* rows = reinterpret_cast<const float4*>(d_pair);
  cudaStream_t s = (cudaStream_t)stream;
  switch (row) {
    case 12:
      bin_bwd_atomic_kernel<3><<<blocks, kThreads, 0, s>>>(rows, idx, view_max, d_feat, (int)n_pairs, views, g);
      break;
    case 16:
      bin_bwd_atomic_kernel<4><<<blocks, kThreads, 0, s>>>(rows, idx, view_max, d_feat, (int)n_pairs, views, g);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The sorted mode's order. idx (n_pairs,) and ranges (views * ntx * nty, 2)
// are K1's lists, rects (views * g, 2) its packed rectangles; scratch holds
// 4 views * g + ceil(views * g / 2048) + views * ntx * nty ints, 16-byte
// aligned. Writes perm
// (n_pairs,) int32, the list entries Gaussian by Gaussian (each Gaussian's
// in list order), and offsets (views * g + 1,) int32, each Gaussian's
// segment start in perm.
extern "C" int tp_bin_bwd_order(const int* idx, const int* ranges, const int* rects, int* scratch, int* perm,
                                int* offsets, long long n_pairs, int views, int g, int ntx, int nty, void* stream) {
  const long long n_rows = (long long)views * g, tiles = (long long)ntx * nty, cells = views * tiles;
  if (views <= 0 || g <= 0 || ntx <= 0 || nty <= 0 || n_rows >= (1LL << 31) || tiles >= (1LL << 31) ||
      n_pairs >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (int)((n_rows + kScanRows - 1) / kScanRows);
  if (n_blocks > kMaxScanBlocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int4* rec = reinterpret_cast<int4*>(scratch);
  int* block_sums = scratch + 4 * n_rows;
  int* cell_end = block_sums + n_blocks;
  bin_bwd_offsets_kernel<<<n_blocks, kScanThreads, 0, s>>>(reinterpret_cast<const int2*>(rects),
                                                            reinterpret_cast<const int2*>(ranges), rec, block_sums,
                                                            cell_end, n_rows, cells);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      std::max(std::max((n_pairs + kPermEntries - 1) / kPermEntries, (n_rows + 1 + 4095) / 4096), 1LL);
  const long long rows_per_block = (n_rows + 1 + blocks - 1) / blocks;
  const size_t smem = (size_t)n_blocks * sizeof(int);
  err = cudaFuncSetAttribute(bin_bwd_perm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bin_bwd_perm_kernel<<<(unsigned)blocks, kPermThreads, smem, s>>>(
      idx, cell_end, rec, block_sums, perm, offsets, n_pairs, n_rows, cells,
      rows_per_block, n_blocks, g, ntx, (int)tiles);
  return (int)cudaGetLastError();
}

// perm and offsets from tp_bin_bwd_order; row is 12 or 16 (16-byte aligned
// rows). Every value of d_feat (n_rows, row) is written.
extern "C" int tp_bin_bwd_sorted(const float* d_pair, const int* perm, const int* offsets, float* d_feat,
                                 long long n_rows, long long n_pairs, int row, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float4* src = reinterpret_cast<const float4*>(d_pair);
  float4* dst = reinterpret_cast<float4*>(d_feat);
  switch (row) {
    case 12:
      bin_bwd_sorted_kernel<3><<<blocks_for(3 * n_rows, 256), 256, 0, s>>>(src, perm, offsets, dst, n_rows, n_pairs);
      break;
    case 16:
      bin_bwd_sorted_kernel<4><<<blocks_for(4 * n_rows, 256), 256, 0, s>>>(src, perm, offsets, dst, n_rows, n_pairs);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
