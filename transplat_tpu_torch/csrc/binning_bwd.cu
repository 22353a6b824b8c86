// Tile binning, backward (K2): list-entry gradients back to Gaussian rows.
//
// Replaces: transplat_tpu/ops/rasterizer/pallas_binning.py `_bin_bwd_kernel`
// (the backward of `bin_pallas`).
//
// Computes the transpose of the forward's routing (binning.cu): every
// tile-list entry k names one depth-sorted Gaussian idx[k] of the view its
// tile belongs to, and its gradient row d_pair[k, :] (8 + C floats, from
// composite_bwd.cu) is added to that Gaussian's row:
//   d_feat[view(k), idx[k], :] += d_pair[k, :]
// d_feat (B, G, 8 + C) holds the geometry gradient (8 columns) and the colour
// gradient (C columns) side by side. The TPU kernel also zeroes the gradient
// of entries dropped at capacity; the port's lists have no capacity and drop
// nothing, so that rule has nothing to apply to here.
//
// What bounds it on an H100: device-memory bytes. d_pair (4 (8 + C) bytes per
// entry) and idx are read once and d_feat is written once; there is one add
// per value.
//
// Design, two modes:
//   * atomic (default): one thread per (entry, column); coalesced reads of
//     d_pair, one float atomic add (red.global.add.f32) per non-zero value
//     into the zeroed output. The view of an entry comes from the running
//     ends of the views' pair counts (entries are sorted by view, then tile).
//     The order of the adds, and so the last bits, change from run to run.
//   * sorted (deterministic): the caller sorts the entries by
//     view * G + idx, stably (torch.sort, a radix sort like K1's), and gives
//     each Gaussian's [start, end) in that order (the bin_ranges kernel); one
//     thread per (Gaussian, column) adds its segment in order and writes
//     once. Same bits on every run.
//
// Not carried over from the TPU kernel: the one-hot MXU contraction that
// un-routes the worklists chunk by chunk and the capacity windows. Hopper
// scatters with atomics.

#include <cuda_runtime.h>

namespace {

__global__ void bin_bwd_atomic_kernel(const float* __restrict__ d_pair,
                                      const int* __restrict__ idx,
                                      const long long* __restrict__ view_end,
                                      float* __restrict__ d_feat, long long n_vals, int row,
                                      int views, int g) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_vals) return;
  const float x = d_pair[i];
  if (x == 0.0f) return;  // radius and pad columns, entries past saturation
  const long long k = i / row;
  const int c = (int)(i - k * row);
  int view = 0;
  while (view < views - 1 && k >= view_end[view]) ++view;
  atomicAdd(d_feat + ((long long)view * g + idx[k]) * row + c, x);
}

__global__ void bin_bwd_sorted_kernel(const float* __restrict__ d_pair,
                                      const long long* __restrict__ perm,
                                      const int2* __restrict__ segments,
                                      float* __restrict__ d_feat, long long n_out, int row) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const long long gi = i / row;
  const int c = (int)(i - gi * row);
  const int2 seg = segments[gi];
  float sum = 0.0f;
  for (int j = seg.x; j < seg.y; ++j) sum += d_pair[perm[j] * row + c];
  d_feat[i] = sum;
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// d_feat (views * g, row) must arrive zeroed; view_end (views,) holds the
// inclusive running count of list entries per view.
extern "C" int tp_bin_bwd(const float* d_pair, const int* idx, const long long* view_end,
                          float* d_feat, long long n_pairs, int row, int views, int g,
                          void* stream) {
  if (n_pairs == 0) return 0;
  const long long n_vals = n_pairs * row;
  bin_bwd_atomic_kernel<<<blocks_for(n_vals, 256), 256, 0, (cudaStream_t)stream>>>(
      d_pair, idx, view_end, d_feat, n_vals, row, views, g);
  return (int)cudaGetLastError();
}

// perm (n_pairs,) int64 sorts the entries by view * g + idx; segments
// (views * g, 2) holds each Gaussian's [start, end) in that order. Every
// value of d_feat (views * g, row) is written.
extern "C" int tp_bin_bwd_sorted(const float* d_pair, const long long* perm, const int* segments,
                                 float* d_feat, long long n_gaussians, int row, void* stream) {
  if (n_gaussians == 0) return 0;
  const long long n_out = n_gaussians * row;
  bin_bwd_sorted_kernel<<<blocks_for(n_out, 256), 256, 0, (cudaStream_t)stream>>>(
      d_pair, perm, reinterpret_cast<const int2*>(segments), d_feat, n_out, row);
  return (int)cudaGetLastError();
}
