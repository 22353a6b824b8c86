// Deformable value sampling, forward (K7).
//
// Replaces: transplat_tpu/ops/deform_pallas.py `_vectors_fwd_kernel` (behind
// `deform_sample_vectors_pallas`, the opt-in TPU form of ops/deform.py
// `deform_sample_vectors`, the value sampling of the UV self-attention).
//
// Computes, for every batch entry n (a directed view pair) and query q,
//   out[n, q, :] = sum_p aw[n, q, p] * bilinear(V[n] as (H, W, C), loc[n, q, p])
//                = sum_{p, corner} aw * w_corner * V[n, idx_corner, :]
// with mmcv's conventions: loc in [0, 1], align_corners=False, zero padding.
//
// What bounds it on an H100: device-memory bytes. V (4 H W C bytes per batch
// entry: 2 MB at 64x64x128) is read by every query but fits the 50 MB L2, so
// it leaves device memory once; loc and aw are read once and out (4 Q C
// bytes) is written once. The 2 * 4P * C flops per query are negligible.
//
// Design: one warp per query, four queries per block. The lanes first compute
// the corner tables: lane l takes point l / 4 and corner l % 4 of a pass of 8
// points, so the 4P corners of a query at P <= 8 are computed once, in
// parallel. Then the lanes turn to the channels (a float4 each where
// C % 4 == 0, so a 128-channel row is one 512-byte coalesced read per
// corner), take each corner's index and weight from its lane with a shuffle,
// and accumulate aw * w_corner * V[idx, c] in registers; out[q, c] is written
// once. Any H, W, C, P, Q and batch size: nothing of the TPU kernel's shape
// limits applies.
//
// Not carried over from the TPU kernel: the dense one-hot (query block, H W)
// matrix A and the A V matmul at HIGHEST precision. They stood in for a
// gather, which the card does directly.

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

// kVec: channels are walked as float4 (C % 4 == 0 and 16-byte aligned rows).
template <bool kVec>
__global__ void deform_vectors_kernel(const float* __restrict__ value,
                                      const float* __restrict__ loc,
                                      const float* __restrict__ aw, float* __restrict__ out,
                                      long long n_queries, int q, int h, int w, int c, int p) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long nq = blockIdx.x * (long long)kWarpsPerBlock + (threadIdx.x >> 5);
  if (nq >= n_queries) return;  // whole warps leave together
  const long long n = nq / q;
  const float* v_map = value + n * (long long)h * w * c;
  const float* q_loc = loc + nq * (long long)p * 2;
  const float* q_aw = aw + nq * (long long)p;
  float* q_out = out + nq * (long long)c;
  const int step = kVec ? 4 * kWarp : kWarp;
  for (int c0 = 0; c0 < c; c0 += step) {
    const int ch = c0 + (kVec ? 4 * lane : lane);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int p0 = 0; p0 < p; p0 += kPointsPerPass) {
      const int pi = p0 + (lane >> 2);
      float cw = 0.0f;
      int index = -1;
      if (pi < p) {
        const Corner k = make_corner(q_loc[2 * pi], q_loc[2 * pi + 1], lane & 3, h, w);
        cw = k.weight * q_aw[pi];
        index = k.index;
      }
      const int corners = 4 * min(kPointsPerPass, p - p0);
      for (int k = 0; k < corners; ++k) {
        const float wk = __shfl_sync(kFull, cw, k);
        const int ik = __shfl_sync(kFull, index, k);
        if (ik < 0 || ch >= c) continue;
        const float* row = v_map + (long long)ik * c + ch;
        if (kVec) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(row));
          acc.x += wk * v.x;
          acc.y += wk * v.y;
          acc.z += wk * v.z;
          acc.w += wk * v.w;
        } else {
          acc.x += wk * __ldg(row);
        }
      }
    }
    if (ch < c) {
      if (kVec) {
        *reinterpret_cast<float4*>(q_out + ch) = acc;
      } else {
        q_out[ch] = acc.x;
      }
    }
  }
}

}  // namespace

// value (n_batch, h * w, c), loc (n_batch, q, p, 2), aw (n_batch, q, p) ->
// out (n_batch, q, c), all float32 and contiguous. Every value of out is
// written.
extern "C" int tp_deform_vectors(const float* value, const float* loc, const float* aw, float* out,
                                 long long n_batch, int q, int h, int w, int c, int p,
                                 void* stream) {
  const long long n_queries = n_batch * q;
  if (n_queries == 0 || c == 0) return 0;
  const unsigned blocks = (unsigned)((n_queries + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int threads = kWarpsPerBlock * kWarp;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (c % 4 == 0) && ((uintptr_t)value % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (vec) {
    deform_vectors_kernel<true><<<blocks, threads, 0, s>>>(value, loc, aw, out, n_queries, q, h, w, c, p);
  } else {
    deform_vectors_kernel<false><<<blocks, threads, 0, s>>>(value, loc, aw, out, n_queries, q, h, w, c, p);
  }
  return (int)cudaGetLastError();
}
