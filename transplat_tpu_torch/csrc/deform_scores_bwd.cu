// Deformable score sampling, backward (K6).
//
// Replaces: transplat_tpu/ops/deform_pallas.py `_scores_bwd_kernel` (with the
// `_pallas_bwd` epilogue that turns its corner-weight gradients into d_loc
// and its unweighted samples into d_attn).
//
// Computes, from gbar = d out (Q, D) of
//   out[q, d] = sum_p aw[q, d, p] * bilinear(S[q] as (H, W), loc[q, d, p]),
// with s = gbar[q, d] * aw[q, d, p], the corner values v00..v11 of a sample
// (0 outside the map) and its fractions wx, wy:
//   d_scores[q, corner] += s * w_corner                       (Q, H*W)
//   d_loc_x = s * W * ((1 - wy) (v01 - v00) + wy (v11 - v10))
//   d_loc_y = s * H * ((1 - wx) (v10 - v00) + wx (v11 - v01))   (Q, D, P, 2)
//   d_aw    = gbar[q, d] * bilinear(S[q], loc[q, d, p])         (Q, D, P)
// floor() is a constant for the gradient, and a corner outside the map
// contributes 0 to every output (zero padding).
//
// What bounds it on an H100: device-memory bytes, most of them the write of
// d_scores (4 H W bytes per query, 134 MB at 2 x 4096 queries of 64x64);
// then loc, aw, gbar read once, d_loc and d_aw written once, and the score
// sectors the corners touch. About 60 flops per sample are negligible.
//
// Design: one block per query, threads walk the D slots, as the forward
// (deform_scores.cu). Row q of d_scores receives from query q only, so the
// block accumulates it in a zeroed shared-memory row (16 KB at 64x64) with
// shared-memory atomic adds and writes it once, coalesced; a row over 48 KB
// is accumulated with atomic adds in the (zeroed) output itself, so every
// shape works. The corner values for d_loc and d_aw are read straight from
// device memory through the read-only path in both cases (the forward's
// second design, staging the score row, is not used here: shared memory
// holds the gradient row). The order of the atomic adds into a row changes
// from run to run, and with it the last bits of d_scores.
//
// Rounding: px = loc_x * W - 0.5 and floor(px) are evaluated in float32 in
// that order (built with -fmad=false), exactly as the forward and the JAX
// `_prep` do, so forward and backward agree on every corner index.
//
// Not carried over from the TPU kernel: the separable one-hot indicator
// matmuls on the MXU (and the difference indicators for the weight
// gradients), the block-diagonal pairing of two queries per matmul and the
// P-major lane layout. A GPU gathers and scatters the four corners directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmemFloats = 48 * 1024 / 4;

template <bool kSharedRow>
__global__ void deform_scores_bwd_kernel(const float* __restrict__ scores,
                                         const float* __restrict__ loc,
                                         const float* __restrict__ aw,
                                         const float* __restrict__ gbar,
                                         float* __restrict__ d_scores, float* __restrict__ d_loc,
                                         float* __restrict__ d_aw, int h, int w, int d, int p) {
  extern __shared__ float s_row[];
  const long long q = blockIdx.x;
  const int hw = h * w;
  const float* row = scores + q * (long long)hw;
  float* d_row = d_scores + q * (long long)hw;
  if (kSharedRow) {
    for (int i = threadIdx.x; i < hw; i += blockDim.x) s_row[i] = 0.0f;
    __syncthreads();
  }
  float* acc = kSharedRow ? s_row : d_row;
  const float fw = (float)w, fh = (float)h;
  for (int di = threadIdx.x; di < d; di += blockDim.x) {
    const long long base = (q * d + di) * (long long)p;
    const float gb = gbar[q * d + di];
    for (int pi = 0; pi < p; ++pi) {
      const float lx = loc[(base + pi) * 2];
      const float ly = loc[(base + pi) * 2 + 1];
      float px = lx * fw - 0.5f;
      float py = ly * fh - 0.5f;
      float x0 = floorf(px);
      float y0 = floorf(py);
      const float wx = px - x0;
      const float wy = py - y0;
      // Far outside the map every corner is padding; clamping the integer
      // corner keeps the conversion defined without changing the result.
      x0 = fminf(fmaxf(x0, -2.0f), fw + 1.0f);
      y0 = fminf(fmaxf(y0, -2.0f), fh + 1.0f);
      const int ix = (int)x0, iy = (int)y0;
      const bool in_x0 = ix >= 0 && ix < w, in_x1 = ix + 1 >= 0 && ix + 1 < w;
      const bool in_y0 = iy >= 0 && iy < h, in_y1 = iy + 1 >= 0 && iy + 1 < h;
      const int i00 = iy * w + ix;
      const float v00 = (in_y0 && in_x0) ? __ldg(row + i00) : 0.0f;
      const float v01 = (in_y0 && in_x1) ? __ldg(row + i00 + 1) : 0.0f;
      const float v10 = (in_y1 && in_x0) ? __ldg(row + i00 + w) : 0.0f;
      const float v11 = (in_y1 && in_x1) ? __ldg(row + i00 + w + 1) : 0.0f;
      const float w00 = (1.0f - wx) * (1.0f - wy), w01 = wx * (1.0f - wy);
      const float w10 = (1.0f - wx) * wy, w11 = wx * wy;
      const float a = aw[base + pi];
      const float s = gb * a;
      d_aw[base + pi] = gb * (v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11);
      d_loc[(base + pi) * 2] = s * fw * ((1.0f - wy) * (v01 - v00) + wy * (v11 - v10));
      d_loc[(base + pi) * 2 + 1] = s * fh * ((1.0f - wx) * (v10 - v00) + wx * (v11 - v01));
      if (in_y0 && in_x0) atomicAdd(acc + i00, s * w00);
      if (in_y0 && in_x1) atomicAdd(acc + i00 + 1, s * w01);
      if (in_y1 && in_x0) atomicAdd(acc + i00 + w, s * w10);
      if (in_y1 && in_x1) atomicAdd(acc + i00 + w + 1, s * w11);
    }
  }
  if (kSharedRow) {
    __syncthreads();
    if ((hw & 3) == 0) {
      const float4* src = reinterpret_cast<const float4*>(s_row);
      float4* dst = reinterpret_cast<float4*>(d_row);
      for (int i = threadIdx.x; i < hw / 4; i += blockDim.x) dst[i] = src[i];
    } else {
      for (int i = threadIdx.x; i < hw; i += blockDim.x) d_row[i] = s_row[i];
    }
  }
}

}  // namespace

// Every value of d_scores, d_loc and d_aw is written (rows over 48 KB are
// zeroed here first, on the same stream).
extern "C" int tp_deform_scores_bwd(const float* scores, const float* loc, const float* aw,
                                    const float* gbar, float* d_scores, float* d_loc, float* d_aw,
                                    long long n_queries, int h, int w, int d, int p,
                                    void* stream) {
  if (n_queries == 0) return 0;
  const int hw = h * w;
  const int threads = d < 32 ? 32 : (d > 256 ? 256 : ((d + 31) / 32) * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (hw <= kMaxSmemFloats) {
    deform_scores_bwd_kernel<true><<<(unsigned)n_queries, threads, (size_t)hw * sizeof(float), s>>>(
        scores, loc, aw, gbar, d_scores, d_loc, d_aw, h, w, d, p);
  } else {
    const cudaError_t err =
        cudaMemsetAsync(d_scores, 0, (size_t)n_queries * hw * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    deform_scores_bwd_kernel<false><<<(unsigned)n_queries, threads, 0, s>>>(
        scores, loc, aw, gbar, d_scores, d_loc, d_aw, h, w, d, p);
  }
  return (int)cudaGetLastError();
}
