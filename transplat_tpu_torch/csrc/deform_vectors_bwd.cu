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
// flops per query are negligible. What it costs in practice is the 4P * C
// atomic adds per query into d_value: self-attention offsets are small, so
// the corners of neighbouring queries fall on the same few rows and their
// adds collide in L2.
//
// Design: one warp per query, four queries per block, the forward's layout
// (deform_vectors.cu). Lane l computes point l / 4, corner l % 4 of a pass of
// 8 points. For each corner inside the map the lanes walk the channels (a
// float4 each where C % 4 == 0): they add aw * w_corner * gbar to the
// corner's d_value row with atomics (one 16-byte vector atomic per lane on
// sm_90) and take the partial dot product <gbar, V[idx]>, which a shuffle
// tree sums over the warp in a fixed order. The four lanes of a point then
// exchange their corner sums and lane `corner 0` writes d_aw and d_loc.
// Two modes:
//   * atomic (default): d_value must arrive zeroed; the order of the adds,
//     and so the last bits of d_value, change from run to run.
//   * sorted (deterministic): the kernel adds nothing to d_value but writes
//     each corner's key n * HW + idx (N * HW outside the map) and weight
//     aw * w_corner; the caller sorts the keys stably (torch.sort), gets each
//     row's [start, end) in that order (the bin_ranges kernel), and
//     `tp_deform_vectors_bwd_sorted` adds each row's segment in order, one
//     thread per (row, channel), writing every value once. Same bits on
//     every run. d_loc and d_aw are deterministic in both modes.
//
// Not carried over from the TPU kernel: the dense one-hot (query block, H W)
// matrix A, dA = gbar V^T as a full matmul with masked lane reductions, and
// dV accumulated across a sequential grid. Blocks run in parallel here, so
// dV takes atomics (or the sorted pass).

#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_vectors.cuh"

namespace {

using deform_vectors::Corner;
using deform_vectors::kPointsPerPass;
using deform_vectors::kWarp;
using deform_vectors::make_corner;

constexpr int kWarpsPerBlock = 4;
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

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = kWarp / 2; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// kVec: channels are walked as float4. d_value == nullptr selects the sorted
// mode's first pass (keys and corner weights out, no adds).
template <bool kVec>
__global__ void deform_vectors_bwd_kernel(const float* __restrict__ value,
                                          const float* __restrict__ loc,
                                          const float* __restrict__ aw,
                                          const float* __restrict__ gbar, float* d_value,
                                          float* __restrict__ d_loc, float* __restrict__ d_aw,
                                          int* __restrict__ keys, float* __restrict__ corner_w,
                                          long long n_queries, long long n_batch, int q, int h,
                                          int w, int c, int p) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long nq = blockIdx.x * (long long)kWarpsPerBlock + (threadIdx.x >> 5);
  if (nq >= n_queries) return;  // whole warps leave together
  const long long n = nq / q;
  const long long hw = (long long)h * w;
  const float* v_map = value + n * hw * c;
  float* dv_map = d_value ? d_value + n * hw * c : nullptr;
  const float* q_g = gbar + nq * (long long)c;
  const int step = kVec ? 4 * kWarp : kWarp;
  for (int p0 = 0; p0 < p; p0 += kPointsPerPass) {
    const int pi = p0 + (lane >> 2);
    const long long point = nq * (long long)p + pi;
    Corner k = {0.0f, 0.0f, 0.0f, -1};
    float a = 0.0f;
    if (pi < p) {
      k = make_corner(loc[2 * point], loc[2 * point + 1], lane & 3, h, w);
      a = aw[point];
      if (keys) {
        keys[4 * point + (lane & 3)] = (int)(k.index < 0 ? n_batch * hw : n * hw + k.index);
        corner_w[4 * point + (lane & 3)] = k.weight * a;
      }
    }
    const float cw = k.weight * a;
    float s = 0.0f;  // this lane's corner: <gbar, V[idx]>, 0 outside the map
    const int corners = 4 * min(kPointsPerPass, p - p0);
    for (int j = 0; j < corners; ++j) {
      const int ij = __shfl_sync(kFull, k.index, j);
      if (ij < 0) continue;  // uniform over the warp
      const float wj = __shfl_sync(kFull, cw, j);
      float dot = 0.0f;
      for (int c0 = 0; c0 < c; c0 += step) {
        const int ch = c0 + (kVec ? 4 * lane : lane);
        if (ch >= c) continue;
        const long long at = (long long)ij * c + ch;
        if (kVec) {
          const float4 g = __ldg(reinterpret_cast<const float4*>(q_g + ch));
          const float4 v = __ldg(reinterpret_cast<const float4*>(v_map + at));
          dot += g.x * v.x + g.y * v.y + g.z * v.z + g.w * v.w;
          if (dv_map) atomic_add4(dv_map + at, make_float4(wj * g.x, wj * g.y, wj * g.z, wj * g.w));
        } else {
          const float g = __ldg(q_g + ch);
          dot += g * __ldg(v_map + at);
          if (dv_map) atomicAdd(dv_map + at, wj * g);
        }
      }
      dot = warp_sum(dot);
      if (lane == j) s = dot;
    }
    // The four lanes of a point hold s00, s01, s10, s11.
    const int first = lane & ~3;
    const float s00 = __shfl_sync(kFull, s, first);
    const float s01 = __shfl_sync(kFull, s, first + 1);
    const float s10 = __shfl_sync(kFull, s, first + 2);
    const float s11 = __shfl_sync(kFull, s, first + 3);
    if (pi < p && (lane & 3) == 0) {
      const float wx = k.wx, wy = k.wy;
      const float w00 = (1.0f - wx) * (1.0f - wy), w01 = wx * (1.0f - wy);
      const float w10 = (1.0f - wx) * wy, w11 = wx * wy;
      d_aw[point] = s00 * w00 + s01 * w01 + s10 * w10 + s11 * w11;
      d_loc[2 * point] = a * (float)w * ((1.0f - wy) * (s01 - s00) + wy * (s11 - s10));
      d_loc[2 * point + 1] = a * (float)h * ((1.0f - wx) * (s10 - s00) + wx * (s11 - s01));
    }
  }
}

// One thread per (row of d_value, channel): the row's corners in sorted
// order, each worth corner_w * gbar[its query, channel].
__global__ void deform_vectors_bwd_sorted_kernel(const float* __restrict__ gbar,
                                                 const float* __restrict__ corner_w,
                                                 const long long* __restrict__ perm,
                                                 const int2* __restrict__ segments,
                                                 float* __restrict__ d_value, long long n_out,
                                                 int c, int corners_per_query) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const long long row = i / c;
  const int ch = (int)(i - row * c);
  const int2 seg = segments[row];
  float sum = 0.0f;
  for (int j = seg.x; j < seg.y; ++j) {
    const long long e = perm[j];
    sum += corner_w[e] * gbar[(e / corners_per_query) * c + ch];
  }
  d_value[i] = sum;
}

}  // namespace

// value (n_batch, h * w, c), loc (n_batch, q, p, 2), aw (n_batch, q, p),
// gbar (n_batch, q, c), float32 and contiguous. Every value of d_loc and d_aw
// is written. Atomic mode: d_value (zeroed by the caller) takes the adds and
// keys, corner_w are null. Sorted mode: d_value is null, and keys (int32) and
// corner_w (n_batch * q * p * 4 each) are written.
extern "C" int tp_deform_vectors_bwd(const float* value, const float* loc, const float* aw,
                                     const float* gbar, float* d_value, float* d_loc, float* d_aw,
                                     int* keys, float* corner_w, long long n_batch, int q, int h,
                                     int w, int c, int p, void* stream) {
  const long long n_queries = n_batch * q;
  if (n_queries == 0 || p == 0) return 0;
  const unsigned blocks = (unsigned)((n_queries + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int threads = kWarpsPerBlock * kWarp;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (c % 4 == 0) && ((uintptr_t)value % 16 == 0) && ((uintptr_t)gbar % 16 == 0) &&
                   ((uintptr_t)d_value % 16 == 0);
  if (vec) {
    deform_vectors_bwd_kernel<true><<<blocks, threads, 0, s>>>(
        value, loc, aw, gbar, d_value, d_loc, d_aw, keys, corner_w, n_queries, n_batch, q, h, w, c, p);
  } else {
    deform_vectors_bwd_kernel<false><<<blocks, threads, 0, s>>>(
        value, loc, aw, gbar, d_value, d_loc, d_aw, keys, corner_w, n_queries, n_batch, q, h, w, c, p);
  }
  return (int)cudaGetLastError();
}

// perm (entries,) int64 sorts the corner keys; segments (n_rows, 2) holds each
// d_value row's [start, end) in that order. Every value of d_value
// (n_rows, c) is written.
extern "C" int tp_deform_vectors_bwd_sorted(const float* gbar, const float* corner_w,
                                            const long long* perm, const int* segments,
                                            float* d_value, long long n_rows, int c,
                                            int corners_per_query, void* stream) {
  const long long n_out = n_rows * c;
  if (n_out == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_out + threads - 1) / threads);
  deform_vectors_bwd_sorted_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      gbar, corner_w, perm, reinterpret_cast<const int2*>(segments), d_value, n_out, c,
      corners_per_query);
  return (int)cudaGetLastError();
}
