// Deformable value sampling, backward (K8).
//
// Replaces: transplat_tpu/ops/deform_pallas.py `_vectors_bwd_kernel` (with the
// `_vec_bwd` epilogue that chains its corner sums through `_vectors_prep` to
// d_loc and d_attn).
//
// Computes, from gbar = d out (N, Q, C) of
//   out[n, q, :] = sum_{p, corner} aw[n, q, p] * w_corner * V[n, idx_corner, :],
// with s_corner = <gbar[n, q, :], V[n, idx_corner, :]> (0 outside the map) and
// the fractions wx, wy of a point:
//   d_value[n, idx_corner, :] += aw * w_corner * gbar[n, q, :]     (N, H W, C)
//   d_aw    = sum_corner w_corner * s_corner                       (N, Q, P)
//   d_loc_x = aw * W * ((1 - wy) (s01 - s00) + wy (s11 - s10))
//   d_loc_y = aw * H * ((1 - wx) (s10 - s00) + wx (s11 - s01))     (N, Q, P, 2)
// floor() is a constant for the gradient, and a corner outside the map
// contributes 0 to every output (zero padding), never NaN.
//
// What bounds it on an H100: device-memory bytes. V, gbar, loc and aw are read
// once, d_value (the size of V), d_loc and d_aw are written once; 4 * 4P * C
// flops per query are negligible. The first design (one warp per query, a
// 16-byte atomic per corner and lane) made 4P * C atomic adds per query into
// d_value: 4.2 M vector atomics, 67 MB, into a 4.2 MB d_value at the path's
// shape, and read a V row from L2 for every corner.
//
// Design: a block of 32 warps takes 64 queries (fewer where P > 16).
//   * Where the queries are the map's own pixels (Q = H W, the
//     self-attention) and their corners fit (P <= 16), the 64 queries are an
//     8x8 tile of the map, and the block stages in shared memory, with
//     cp.async, the V rows of the tile plus a 4-cell halo (a 16x16 window)
//     and the tile's gbar rows, 128 channels at a time (128 + 32 KB). The
//     copies run while the block works out every corner: its map index,
//     aw * w_corner, and its bucket (its window cell, or "outside").
//   * The corners are then grouped by bucket (counts, a scan, a placement,
//     all with integer atomics in shared memory), and a warp sums each
//     window cell's corners over its lanes' channels and adds the sum to
//     d_value with one 16-byte atomic per lane: a row of d_value takes an add
//     from each of the (at most four) windows that cover it instead of one
//     per corner. Corners outside the window (far offsets, points outside
//     the map's edge region) add to d_value one by one, so any offset is
//     right. Elsewhere (Q != H W, or P > 16) every corner takes that route.
//   * The dot products <gbar, V[idx]> read the staged rows (V from device
//     memory for a corner outside the window); a warp takes a point, its
//     lanes 4 channels each, and reduces the four corners' products in one
//     butterfly of five shuffles, not four trees of five. The sums collect
//     in shared memory over the channel slices, then d_aw and d_loc.
// Two modes:
//   * atomic (default): d_value must arrive zeroed; the order of the adds,
//     and so the last bits of d_value, change from run to run.
//   * sorted (deterministic): the kernel adds nothing to d_value but writes
//     each corner's key n * HW + idx (N * HW outside the map) and weight
//     aw * w_corner. A stable counting sort of the keys, K1's count / scan /
//     place (binning.cu) with a corner's one key in place of a Gaussian's
//     tiles, orders the corners by d_value row with no library sort:
//       - deform_vectors_bwd_count: a block per chunk of kSortChunk consecutive
//         corners of one batch entry n and a slice of its HW + 1 cells (the
//         map's and "outside"): a shared-memory histogram -> the count table
//         (n, chunk, HW + 1 cells), written as runs;
//       - deform_vectors_bwd_scan: a thread per (n, cell) row turns its column of
//         counts into their exclusive prefix over the chunks (neighbouring
//         threads read neighbouring cells); the last block to finish scans
//         the rows' totals, the map cells of every n first and then the
//         outside cells, into each row's start and the keys' segment starts
//         `offsets` (N * HW + 2, int32);
//       - deform_vectors_bwd_place: the block of the count, again; each warp
//         counts its 256 corners per cell, the cursors start at the row's
//         start + its chunk prefix + the counts of the block's earlier
//         warps, and the warp places its corners 32 at a time in order, a
//         lane at its cursor plus the lanes below it with the same cell
//         (__match_any_sync): perm[place] = corner (int32).
//     Ties keep the corners' order, so perm is what a stable sort of the
//     keys gives, the outside corners last, and no library sort runs. Then
//     `tp_deform_vectors_bwd_sorted` adds each row's segment in order, one
//     warp per row with its lanes over the channels, writing every value
//     once. Same bits on every run. d_loc and d_aw are deterministic in both
//     modes. The count does not take the corners from the first kernel's
//     blocks: a tile-mode block holds an 8x8 tile of queries, not a run of
//     consecutive corners, and the sort's chunks must be runs.

// Not carried over from the TPU kernel: the dense one-hot (query block, H W)
// matrix A, dA = gbar V^T as a full matmul with masked lane reductions, and
// dV accumulated across a sequential grid. Blocks run in parallel here, so
// dV takes atomics (or the sorted pass).

#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_vectors.cuh"

namespace {

using deform_vectors::Corner;
using deform_vectors::kWarp;
using deform_vectors::make_corner;

constexpr int kTile = 8;                    // tile mode: 8x8 queries a block
constexpr int kHalo = 4;                    // window cells on each side of the tile
constexpr int kWin = kTile + 2 * kHalo;     // 16x16 window
constexpr int kWinCells = kWin * kWin;
constexpr int kOutside = kWinCells;         // bucket of the in-map corners outside the window
constexpr int kBuckets = kWinCells + 1;
constexpr int kSlice = 4 * kWarp;           // channels a block holds at once: 4 a lane
constexpr int kPerLane = kSlice / kWarp;
constexpr int kWarpsPerBlock = 32;
constexpr int kThreads = kWarpsPerBlock * kWarp;
constexpr int kMaxEntries = 4096;           // corner entries (queries x 4P) a block keeps
constexpr unsigned kFull = 0xffffffffu;

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

// Channels ch..ch + 3 of a row (0 past c). kVec: one 16-byte load.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* row, int ch, int c) {
  if (kVec) return ch < c ? __ldg(reinterpret_cast<const float4*>(row + ch)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = ch + t < c ? __ldg(row + ch + t) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// row[ch..ch + 3] += v (channels past c left alone), with device-memory atomics.
template <bool kVec>
__device__ __forceinline__ void add4(float* row, int ch, int c, float4 v) {
  if (kVec) {
    if (ch < c) atomic_add4(row + ch, v);
    return;
  }
  const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (ch + t < c) atomicAdd(row + ch + t, vals[t]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// dst = channels ch..ch + 3 of a row, or 0 where `valid` is false: a 16-byte
// copy that does not wait (kVec), else loads and a store.
template <bool kVec>
__device__ __forceinline__ void stage4(float4* dst, const float* row, int ch, int c, bool valid) {
  if (kVec && valid && ch < c) {
    cp_async16(dst, row + ch);
  } else {
    *dst = valid ? load4<kVec>(row, ch, c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) { return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w; }

__device__ __forceinline__ void fma4(float4& acc, float s, float4 g) {
  acc.x += s * g.x;
  acc.y += s * g.y;
  acc.z += s * g.z;
  acc.w += s * g.w;
}

// Sum x0..x3 over the warp at once; lane l returns the sum of x[(l >> 3) & 3]
// (lanes 0, 8, 16, 24 hold corners 0, 1, 2, 3). The order is fixed.
__device__ __forceinline__ float warp_sum4(float x0, float x1, float x2, float x3, int lane) {
  const bool hi16 = lane & 16;
  float a0 = hi16 ? x2 : x0, a1 = hi16 ? x3 : x1;
  const float b0 = hi16 ? x0 : x2, b1 = hi16 ? x1 : x3;
  a0 += __shfl_xor_sync(kFull, b0, 16);
  a1 += __shfl_xor_sync(kFull, b1, 16);
  const bool hi8 = lane & 8;
  float s = hi8 ? a1 : a0;
  s += __shfl_xor_sync(kFull, hi8 ? a0 : a1, 8);
  s += __shfl_xor_sync(kFull, s, 4);
  s += __shfl_xor_sync(kFull, s, 2);
  s += __shfl_xor_sync(kFull, s, 1);
  return s;
}

// The queries of one block: an 8x8 tile of the map (tile mode, Q = H W) or
// `group` consecutive queries (list mode, no window).
struct Block {
  long long n;
  int x0, y0, first, group;
  bool tiles;
  __device__ long long query(int i, int q, int h, int w) const {
    if (tiles) {
      const int x = x0 + (i & (kTile - 1)), y = y0 + i / kTile;
      return (x < w && y < h) ? n * q + (long long)y * w + x : -1;
    }
    const int qi = first + i;
    return qi < q ? n * q + qi : -1;
  }
  // The window cell of map index idx, or -1.
  __device__ int window_cell(int idx, int w) const {
    if (!tiles) return -1;
    const int wx = idx % w - (x0 - kHalo), wy = idx / w - (y0 - kHalo);
    return (wx >= 0 && wx < kWin && wy >= 0 && wy < kWin) ? wy * kWin + wx : -1;
  }
};

// kAtomic: add into d_value; otherwise write the sorted mode's keys and
// corner weights. kVec: channels as float4 (C % 4 == 0, value, gbar and
// d_value 16-byte aligned).
template <bool kAtomic, bool kVec>
__global__ void __launch_bounds__(kThreads) deform_vectors_bwd_kernel(
    const float* __restrict__ value, const float2* __restrict__ loc, const float* __restrict__ aw,
    const float* __restrict__ gbar, float* d_value, float2* __restrict__ d_loc, float* __restrict__ d_aw,
    int* __restrict__ keys, float* __restrict__ corner_w, long long n_batch, int q, int h, int w, int c, int p,
    int tiles, int group) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  const long long hw = (long long)h * w;
  Block blk;
  blk.tiles = tiles != 0;
  if (blk.tiles) {
    const int tx = (w + kTile - 1) / kTile, ty = (h + kTile - 1) / kTile;
    blk.n = blockIdx.x / (tx * ty);
    const int t = blockIdx.x % (tx * ty);
    blk.x0 = (t % tx) * kTile;
    blk.y0 = (t / tx) * kTile;
    blk.first = 0;
    blk.group = kTile * kTile;
  } else {
    const int groups = (q + group - 1) / group;
    blk.n = blockIdx.x / groups;
    blk.first = (blockIdx.x % groups) * group;
    blk.group = group;
    blk.x0 = blk.y0 = 0;
  }
  const int corners = 4 * p;
  const int entries = blk.group * corners;  // entry e: query e / 4P, point (e % 4P) / 4, corner e % 4
  float4* gwin = reinterpret_cast<float4*>(smem);  // the block's gbar rows, group x kSlice
  float4* vwin = gwin + blk.group * kWarp;          // tile mode: the window's V, kWinCells x kSlice
  int* e_idx = reinterpret_cast<int*>(smem + blk.group * kSlice + (blk.tiles ? kWinCells * kSlice : 0));
  float* e_cw = reinterpret_cast<float*>(e_idx + entries);
  int* e_bucket = reinterpret_cast<int*>(e_cw + entries);
  float* s_dot = reinterpret_cast<float*>(e_bucket + entries);
  int* list = reinterpret_cast<int*>(s_dot + entries);
  int* start = list + entries;  // kBuckets + 1
  int* cursor = start + kBuckets + 1;
  const float* v_map = value + blk.n * hw * c;
  float* dv_map = kAtomic ? d_value + blk.n * hw * c : nullptr;
  const int wx0 = blk.x0 - kHalo, wy0 = blk.y0 - kHalo;
  // The block's gbar rows and (tile mode) the window's V, one channel slice:
  // copies that run while the corners are worked out.
  auto stage_slice = [&](int c0) {
    for (int i = threadIdx.x; i < blk.group * kWarp; i += kThreads) {
      const long long gq = blk.query(i / kWarp, q, h, w);
      stage4<kVec>(gwin + i, gbar + (gq < 0 ? 0 : gq) * c, c0 + 4 * (i % kWarp), c, gq >= 0);
    }
    if (blk.tiles) {
      for (int i = threadIdx.x; i < kWinCells * kWarp; i += kThreads) {
        const int cell = i / kWarp;
        const int x = wx0 + cell % kWin, y = wy0 + cell / kWin;
        const bool inside = x >= 0 && x < w && y >= 0 && y < h;
        stage4<kVec>(vwin + i, v_map + (inside ? (long long)y * w + x : 0) * c, c0 + 4 * (i % kWarp), c, inside);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage_slice(0);

  // Every corner entry: map index, aw * bilinear weight, bucket (window cell,
  // kOutside, or -1 outside the map); counts per bucket.
  for (int b = threadIdx.x; b <= kBuckets; b += kThreads) start[b] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < entries; e += kThreads) {
    const int i = e / corners, pi = (e - i * corners) >> 2, cr = e & 3;
    const long long gq = blk.query(i, q, h, w);
    int idx = -1, bucket = -1;
    float cw = 0.0f;
    if (gq >= 0) {
      const long long point = gq * p + pi;
      const float2 l = __ldg(loc + point);
      const Corner k = make_corner(l.x, l.y, cr, h, w);
      idx = k.index;
      cw = k.weight * __ldg(aw + point);
      if (!kAtomic) {
        keys[4 * point + cr] = (int)(idx < 0 ? n_batch * hw : blk.n * hw + idx);
        corner_w[4 * point + cr] = cw;
      }
      if (idx >= 0) {
        const int cell = blk.window_cell(idx, w);
        bucket = cell >= 0 ? cell : kOutside;
        if (kAtomic) atomicAdd(start + bucket, 1);
      }
    }
    e_idx[e] = idx;
    e_cw[e] = cw;
    e_bucket[e] = bucket;
    s_dot[e] = 0.0f;
  }
  __syncthreads();
  if (kAtomic) {
    // Counts -> each bucket's start (exclusive scan by warp 0), then the entries by bucket.
    if (warp == 0) {
      constexpr int kPer = (kBuckets + kWarp - 1) / kWarp;
      int sum = 0;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int b = lane * kPer + t;
        sum += b < kBuckets ? start[b] : 0;
      }
      int incl = sum;
      for (int off = 1; off < kWarp; off <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += up;
      }
      int run = incl - sum;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int b = lane * kPer + t;
        if (b < kBuckets) {
          const int v = start[b];
          start[b] = cursor[b] = run;
          run += v;
        }
      }
      if (lane == kWarp - 1) start[kBuckets] = incl;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < entries; e += kThreads)
      if (e_bucket[e] >= 0) list[atomicAdd(cursor + e_bucket[e], 1)] = e;
  }

  for (int c0 = 0; c0 < c; c0 += kSlice) {
    const int ch = c0 + 4 * lane;
    if (c0 > 0) stage_slice(c0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // <gbar, V[idx]> of every corner: a warp per point, lanes over the channels.
    for (int pt = warp; pt < blk.group * p; pt += kWarpsPerBlock) {
      const long long gq = blk.query(pt / p, q, h, w);
      if (gq < 0) continue;  // uniform over the warp
      const float4 g = gwin[(pt / p) * kWarp + lane];
      float dot[4];
#pragma unroll
      for (int cr = 0; cr < 4; ++cr) {
        const int idx = e_idx[4 * pt + cr], b = e_bucket[4 * pt + cr];
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (idx >= 0) v = b < kWinCells ? vwin[b * kWarp + lane] : load4<kVec>(v_map + (long long)idx * c, ch, c);
        dot[cr] = dot4(g, v);
      }
      const float sum = warp_sum4(dot[0], dot[1], dot[2], dot[3], lane);
      if ((lane & 7) == 0) s_dot[4 * pt + (lane >> 3)] += sum;
    }
    if (kAtomic) {
      // Each window cell's corners summed here, one add per cell to d_value.
      for (int b = warp; b < kWinCells; b += kWarpsPerBlock) {
        const int s0 = start[b], s1 = start[b + 1];
        if (s0 == s1) continue;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int j = s0; j < s1; ++j) {
          const int e = list[j];
          fma4(acc, e_cw[e], gwin[(e / corners) * kWarp + lane]);
        }
        const int x = wx0 + b % kWin, y = wy0 + b / kWin;
        add4<kVec>(dv_map + ((long long)y * w + x) * c, ch, c, acc);
      }
      // Corners outside the window: one add each.
      for (int j = start[kOutside] + warp; j < start[kBuckets]; j += kWarpsPerBlock) {
        const int e = list[j];
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        fma4(v, e_cw[e], gwin[(e / corners) * kWarp + lane]);
        add4<kVec>(dv_map + (long long)e_idx[e] * c, ch, c, v);
      }
    }
    __syncthreads();
  }

  // d_aw and d_loc of every (query, point) of the block.
  for (int pt = threadIdx.x; pt < blk.group * p; pt += kThreads) {
    const long long gq = blk.query(pt / p, q, h, w);
    if (gq < 0) continue;
    const long long point = gq * p + pt % p;
    const float2 l = __ldg(loc + point);
    const float a = __ldg(aw + point);
    const Corner k = make_corner(l.x, l.y, 0, h, w);
    const float* s = s_dot + 4 * pt;
    const float s00 = s[0], s01 = s[1], s10 = s[2], s11 = s[3];
    const float wx = k.wx, wy = k.wy;
    const float w00 = (1.0f - wx) * (1.0f - wy), w01 = wx * (1.0f - wy);
    const float w10 = (1.0f - wx) * wy, w11 = wx * wy;
    d_aw[point] = s00 * w00 + s01 * w01 + s10 * w10 + s11 * w11;
    d_loc[point] = make_float2(a * (float)w * ((1.0f - wy) * (s01 - s00) + wy * (s11 - s10)),
                               a * (float)h * ((1.0f - wx) * (s10 - s00) + wx * (s11 - s01)));
  }
}

// The sorted mode's counting sort (see the header). A corner's cell in
// its batch entry n: key - n * HW on the map, HW outside it.
constexpr int kSortChunk = 2048;                       // consecutive corners a count / place block takes
constexpr int kSortWarps = 8;
constexpr int kSortThreads = kSortWarps * kWarp;
constexpr int kSortPerWarp = kSortChunk / kSortWarps;  // consecutive corners a warp places
constexpr int kMaxSliceCells = 6144;                   // cells a block's histogram (and cursors) hold
constexpr int kScanThreadsK8 = 1024;                   // threads a block of the sort's scan takes

__device__ __forceinline__ int corner_cell(int key, long long n, long long hw, long long outside) {
  return key == outside ? (int)hw : (int)(key - n * hw);
}

// A block's batch entry, chunk of corners [e0, e1) and slice of cells [c0, c1).
struct SortBlock {
  long long n, e0, e1;
  int chunk, c0, c1;
  __device__ SortBlock(long long per_batch, int cells, int slice_cells) {
    chunk = blockIdx.x;
    n = blockIdx.y;
    e0 = n * per_batch + (long long)chunk * kSortChunk;
    e1 = n * per_batch + min(per_batch, (long long)(chunk + 1) * kSortChunk);
    c0 = blockIdx.z * slice_cells;
    c1 = min(cells, c0 + slice_cells);
  }
};

// grid (chunks, n_batch, slices), kSortThreads threads, slice_cells ints of
// dynamic shared memory. Zeroes aux[0] for the scan's count of blocks.
__global__ void __launch_bounds__(kSortThreads)
deform_vectors_bwd_count_kernel(const int* __restrict__ keys, int* __restrict__ table, int* __restrict__ aux,
                          long long per_batch, int hw, long long n_batch, int chunks, int slice_cells) {
  extern __shared__ int hist[];
  const SortBlock blk(per_batch, hw + 1, slice_cells);
  const int width = blk.c1 - blk.c0;
  for (int i = threadIdx.x; i < width; i += kSortThreads) hist[i] = 0;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0) aux[0] = 0;
  __syncthreads();
  for (long long e = blk.e0 + threadIdx.x; e < blk.e1; e += kSortThreads) {
    const int cell = corner_cell(__ldg(keys + e), blk.n, hw, n_batch * hw);
    if (cell >= blk.c0 && cell < blk.c1) atomicAdd(hist + cell - blk.c0, 1);
  }
  __syncthreads();
  int* column = table + (blk.n * chunks + blk.chunk) * (hw + 1) + blk.c0;
  for (int i = threadIdx.x; i < width; i += kSortThreads) column[i] = hist[i];
}

// Exclusive sum of one value per thread over the kScanThreadsK8 threads of
// a block (32 warps, whose sums warp 0 scans); *total gets the whole.
// warp_sums holds 33 ints.
__device__ __forceinline__ int scan_block_exclusive_sum(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < kWarp; off <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == kWarp - 1) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int mine = warp_sums[lane];
    int run = mine;
    for (int off = 1; off < kWarp; off <<= 1) {
      const int up = __shfl_up_sync(kFull, run, off);
      if (lane >= off) run += up;
    }
    warp_sums[lane] = run - mine;
    if (lane == kWarp - 1) warp_sums[kWarp] = run;
  }
  __syncthreads();
  *total = warp_sums[kWarp];
  const int start = warp_sums[warp] + incl - v;
  __syncthreads();  // warp_sums may be reused
  return start;
}

// A thread per (n, cell) row: the row's counts over the chunks (the column
// table[n][.][cell]) become their exclusive prefix, its total goes to
// rowtot (loads kLoads at a time, so that a thread's chain of loads is
// short). The last block to finish scans the totals in key order (the map
// cells of n = 0, 1, ..., then the outside cells of n = 0, 1, ...) into
// row_start and offsets.
__global__ void __launch_bounds__(kScanThreadsK8)
deform_vectors_bwd_scan_kernel(int* __restrict__ table, int* rowtot, int* __restrict__ row_start,
                               int* __restrict__ offsets, int* aux, long long n_batch, int chunks, int hw) {
  constexpr int kLoads = 8;
  const long long cells = (long long)hw + 1, rows = n_batch * cells;
  const long long row = blockIdx.x * (long long)kScanThreadsK8 + threadIdx.x;
  if (row < rows) {
    const long long n = row / cells;
    int* column = table + n * chunks * cells + (row - n * cells);
    int run = 0;
    for (int c0 = 0; c0 < chunks; c0 += kLoads) {
      int v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) v[u] = c0 + u < chunks ? column[(c0 + u) * cells] : 0;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (c0 + u < chunks) column[(c0 + u) * cells] = run;
        run += v[u];
      }
    }
    rowtot[row] = run;
  }
  __shared__ bool last;
  __shared__ int warp_sums[kWarp + 1];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(aux, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // The map rows in tiles of four consecutive rows a thread (one 16-byte
  // load), the outside rows after them. One block does it all: it counts
  // instructions, so 32-bit arithmetic (rows < 2^31) and one scan a tile.
  const int n_rows = (int)rows, n_cells = (int)cells, map_keys = (int)(n_batch * hw);
  int carry = 0;
  for (int t0 = 0; t0 < n_rows; t0 += 4 * kScanThreadsK8) {
    const int r0 = t0 + 4 * (int)threadIdx.x;
    int v[4];
    if (r0 + 3 < n_rows) {
      const int4 q = __ldcg(reinterpret_cast<const int4*>(rowtot + r0));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = r0 + u < n_rows ? __ldcg(rowtot + r0 + u) : 0;
    }
    int n = r0 / n_cells, cell = r0 - n * n_cells, sum = 0;
    int key[4];  // the row's key, or -1 for an outside row (or none)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      key[u] = r0 + u < n_rows && cell != hw ? r0 + u - n : -1;
      sum += key[u] >= 0 ? v[u] : 0;
      if (++cell == n_cells) cell = 0, ++n;
    }
    int total;
    int start = carry + scan_block_exclusive_sum(sum, warp_sums, &total);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (key[u] >= 0) {
        row_start[r0 + u] = start;
        offsets[key[u]] = start;
        start += v[u];
      }
    }
    carry += total;
  }
  for (int j0 = 0; j0 < n_batch; j0 += kScanThreadsK8) {
    const int j = j0 + (int)threadIdx.x, r = j * n_cells + hw;
    int total;
    const int start = carry + scan_block_exclusive_sum(j < n_batch ? __ldcg(rowtot + r) : 0, warp_sums, &total);
    if (j < n_batch) row_start[r] = start;
    if (j == 0) offsets[map_keys] = start;  // the outside corners' start
    carry += total;
  }
  if (threadIdx.x == 0) offsets[map_keys + 1] = carry;
}

// grid and block as the count's; dynamic shared memory: a cursor per warp
// and cell of the slice.
__global__ void __launch_bounds__(kSortThreads)
deform_vectors_bwd_place_kernel(const int* __restrict__ keys, const int* __restrict__ bases,
                          const int* __restrict__ row_start, int* __restrict__ perm, long long per_batch, int hw,
                          long long n_batch, int chunks, int slice_cells) {
  extern __shared__ int cursor[];  // [kSortWarps][width]
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  const SortBlock blk(per_batch, hw + 1, slice_cells);
  const int width = blk.c1 - blk.c0;
  const long long outside = n_batch * hw;
  for (int i = threadIdx.x; i < kSortWarps * width; i += kSortThreads) cursor[i] = 0;
  __syncthreads();
  int* mine = cursor + warp * width;
  const long long w0 = min(blk.e1, blk.e0 + (long long)warp * kSortPerWarp), w1 = min(blk.e1, w0 + kSortPerWarp);
  for (long long e = w0 + lane; e < w1; e += kWarp) {
    const int cell = corner_cell(__ldg(keys + e), blk.n, hw, outside);
    if (cell >= blk.c0 && cell < blk.c1) atomicAdd(mine + cell - blk.c0, 1);
  }
  __syncthreads();
  // Counts -> each warp's first place per cell (cells, then warps in order).
  for (int i = threadIdx.x; i < width; i += kSortThreads) {
    int run = __ldg(row_start + blk.n * (hw + 1) + blk.c0 + i) +
              __ldg(bases + (blk.n * chunks + blk.chunk) * (hw + 1) + blk.c0 + i);
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = cursor[w * width + i];
      cursor[w * width + i] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned lower = (1u << lane) - 1u;
  for (long long base = w0; base < w1; base += kWarp) {  // uniform over the warp
    const long long e = base + lane;
    const int cell = e < w1 ? corner_cell(__ldg(keys + e), blk.n, hw, outside) : -1;
    const bool in = e < w1 && cell >= blk.c0 && cell < blk.c1;
    const unsigned peers = __match_any_sync(kFull, in ? cell : -1 - lane);
    int at = 0;
    if (in) {
      at = mine[cell - blk.c0];
      perm[at + __popc(peers & lower)] = (int)e;
    }
    __syncwarp();
    if (in && 31 - __clz(peers) == lane) mine[cell - blk.c0] = at + __popc(peers);  // the cell's highest lane
    __syncwarp();
  }
}

// One warp per row of d_value: the row's corners in sorted order, each worth
// corner_w * gbar[its query, :], lanes over the channels (32 apart).
__global__ void deform_vectors_bwd_sorted_kernel(const float* __restrict__ gbar,
                                                 const float* __restrict__ corner_w,
                                                 const int* __restrict__ perm,
                                                 const int* __restrict__ offsets,
                                                 float* __restrict__ d_value, long long n_rows, int c,
                                                 int corners_per_query) {
  const long long row = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  if (row >= n_rows) return;  // whole warps leave together
  const int s = __ldg(offsets + row), e = __ldg(offsets + row + 1);
  float* out = d_value + row * c;
  for (int c0 = 0; c0 < c; c0 += kSlice) {
    float acc[kPerLane] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = s; j < e; ++j) {
      const int corner = __ldg(perm + j);
      const float cw = __ldg(corner_w + corner);
      const float* g = gbar + (long long)(corner / corners_per_query) * c;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int ch = c0 + lane + k * kWarp;
        if (ch < c) acc[k] += cw * __ldg(g + ch);
      }
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int ch = c0 + lane + k * kWarp;
      if (ch < c) out[ch] = acc[k];
    }
  }
}

template <bool kAtomic, bool kVec>
int launch(size_t smem, unsigned blocks, cudaStream_t s, const float* value, const float* loc, const float* aw,
           const float* gbar, float* d_value, float* d_loc, float* d_aw, int* keys, float* corner_w,
           long long n_batch, int q, int h, int w, int c, int p, int tiles, int group) {
  auto kernel = deform_vectors_bwd_kernel<kAtomic, kVec>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, s>>>(value, reinterpret_cast<const float2*>(loc), aw, gbar, d_value,
                                        reinterpret_cast<float2*>(d_loc), d_aw, keys, corner_w, n_batch, q, h, w,
                                        c, p, tiles, group);
  return (int)cudaGetLastError();
}

}  // namespace

// value (n_batch, h * w, c), loc (n_batch, q, p, 2) 8-byte aligned, aw
// (n_batch, q, p), gbar (n_batch, q, c), float32 and contiguous; 4 p <= 4096.
// Every value of d_loc and d_aw is written. Atomic mode: d_value (zeroed by
// the caller) takes the adds and keys, corner_w are null. Sorted mode:
// d_value is null, and keys (int32) and corner_w (n_batch * q * p * 4 each)
// are written.
extern "C" int tp_deform_vectors_bwd(const float* value, const float* loc, const float* aw,
                                     const float* gbar, float* d_value, float* d_loc, float* d_aw,
                                     int* keys, float* corner_w, long long n_batch, int q, int h,
                                     int w, int c, int p, void* stream) {
  if (n_batch * q == 0 || p == 0) return 0;
  if (4 * p > kMaxEntries) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // Tile mode where the queries are the map's pixels and a tile's entries fit.
  const int tile_queries = kTile * kTile;
  const bool tiles = (long long)q == (long long)h * w && tile_queries * 4 * p <= kMaxEntries;
  const int group = tile_queries * 4 * p <= kMaxEntries ? tile_queries : kMaxEntries / (4 * p);
  const long long per_batch = tiles ? (long long)((w + kTile - 1) / kTile) * ((h + kTile - 1) / kTile)
                                    : (q + group - 1) / group;
  const unsigned blocks = (unsigned)(n_batch * per_batch);
  const size_t smem = ((size_t)group + (tiles ? kWinCells : 0)) * kSlice * sizeof(float) +
                      (size_t)5 * group * 4 * p * sizeof(int) + (size_t)(2 * kBuckets + 1) * sizeof(int);
  const bool atomic = d_value != nullptr;
  const bool vec = (c % 4 == 0) && ((uintptr_t)value % 16 == 0) && ((uintptr_t)gbar % 16 == 0) &&
                   ((uintptr_t)d_value % 16 == 0);
  if (atomic && vec)
    return launch<true, true>(smem, blocks, s, value, loc, aw, gbar, d_value, d_loc, d_aw, keys, corner_w, n_batch,
                              q, h, w, c, p, tiles, group);
  if (atomic)
    return launch<true, false>(smem, blocks, s, value, loc, aw, gbar, d_value, d_loc, d_aw, keys, corner_w, n_batch,
                               q, h, w, c, p, tiles, group);
  if (vec)
    return launch<false, true>(smem, blocks, s, value, loc, aw, gbar, d_value, d_loc, d_aw, keys, corner_w, n_batch,
                               q, h, w, c, p, tiles, group);
  return launch<false, false>(smem, blocks, s, value, loc, aw, gbar, d_value, d_loc, d_aw, keys, corner_w, n_batch,
                              q, h, w, c, p, tiles, group);
}

// keys (n_batch * per_batch,) int32 from the sorted mode of
// tp_deform_vectors_bwd (batch entry n's corners are the n-th run of
// per_batch, their keys n * hw + cell or n_batch * hw), per_batch > 0;
// scratch, 16-byte aligned, holds pad4(rows * chunks) + 2 pad4(rows) + 1
// ints, rows = n_batch * (hw + 1), chunks = ceil(per_batch / 2048), pad4
// rounding up to a multiple of 4. Writes perm (n_batch * per_batch,) int32, the
// corners in key order (ties in corner order), and offsets
// (n_batch * hw + 2,) int32, each key's segment start in perm.
extern "C" int tp_deform_vectors_bwd_order(const int* keys, int* scratch, int* offsets, int* perm, long long n_batch,
                                           long long per_batch, int hw, void* stream) {
  if (n_batch <= 0 || n_batch > 65535 || per_batch <= 0 || hw <= 0 || n_batch * per_batch >= (1LL << 31) ||
      n_batch * ((long long)hw + 1) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long chunks = (per_batch + kSortChunk - 1) / kSortChunk;
  const long long rows = n_batch * ((long long)hw + 1);
  const int slices = (hw + 1 + kMaxSliceCells - 1) / kMaxSliceCells;
  const int slice_cells = (hw + 1 + slices - 1) / slices;
  auto pad4 = [](long long x) { return (x + 3) & ~3LL; };  // rowtot is read as 16-byte vectors
  int* table = scratch;
  int* rowtot = table + pad4(rows * chunks);
  int* row_start = rowtot + pad4(rows);
  int* aux = row_start + pad4(rows);
  const dim3 grid((unsigned)chunks, (unsigned)n_batch, (unsigned)slices);
  deform_vectors_bwd_count_kernel<<<grid, kSortThreads, slice_cells * sizeof(int), s>>>(
      keys, table, aux, per_batch, hw, n_batch, (int)chunks, slice_cells);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  deform_vectors_bwd_scan_kernel<<<(unsigned)((rows + kScanThreadsK8 - 1) / kScanThreadsK8), kScanThreadsK8, 0, s>>>(
      table, rowtot, row_start, offsets, aux, n_batch, (int)chunks, hw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)kSortWarps * slice_cells * sizeof(int);
  err = cudaFuncSetAttribute(deform_vectors_bwd_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  deform_vectors_bwd_place_kernel<<<grid, kSortThreads, smem, s>>>(keys, table, row_start, perm, per_batch, hw, n_batch,
                                                             (int)chunks, slice_cells);
  return (int)cudaGetLastError();
}

// perm and offsets from tp_deform_vectors_bwd_order. Every value of d_value
// (n_rows, c) is written.
extern "C" int tp_deform_vectors_bwd_sorted(const float* gbar, const float* corner_w, const int* perm,
                                            const int* offsets, float* d_value, long long n_rows, int c,
                                            int corners_per_query, void* stream) {
  if (n_rows * c == 0) return 0;
  const int threads = 256;
  const long long warps_per_block = threads / kWarp;
  const unsigned blocks = (unsigned)((n_rows + warps_per_block - 1) / warps_per_block);
  deform_vectors_bwd_sorted_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      gbar, corner_w, perm, offsets, d_value, n_rows, c, corners_per_query);
  return (int)cudaGetLastError();
}
