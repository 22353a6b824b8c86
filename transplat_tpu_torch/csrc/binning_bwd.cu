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
