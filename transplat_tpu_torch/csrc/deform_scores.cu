// Deformable score sampling, forward (K5).
//
// Replaces: transplat_tpu/ops/deform_pallas.py `_scores_fwd_kernel` (the TPU
// kernel behind ops/deform.py `deform_sample_scores`).
//
// Computes, for every query q and depth slot d,
//   out[q, d] = sum_p aw[q, d, p] * bilinear(S[q] as (H, W), loc[q, d, p])
// with mmcv's conventions: loc in [0, 1], align_corners=False, zero padding.
//
// What bounds it on an H100: device-memory bytes. A sample needs its four
// corners, which lie in about two 32-byte sectors of the score row (two rows
// of the map, a pair of neighbours in each). At the flagship shapes (Q = 4096
// per pair, H = W = 64, so 512 sectors per row; D = 128) P = 4 gives 512
// samples per query, which touch most of the row, and P = 1 gives 128, which
// touch well under half of it. Against ~40 flops per sample the arithmetic
// is negligible.
//
// Design: one block per query; threads walk the D slots (one slot per thread
// at D = 128, coalesced loc/aw/out accesses). When the samples are expected
// to touch at least as many sectors as the row holds (2 * D * P >= H * W / 8)
// and the row fits in 48 KB, the block stages the row into shared memory
// with 16-byte loads and gathers the corners there, so each score byte leaves
// device memory once. Otherwise each thread reads its corners straight from
// device memory through the read-only path, so only the sectors that the
// samples touch move: at P = 1 and random locations that is a third of the
// row, so staging it whole would move three times the bytes.
// Every shape is covered, not only the ones the TPU kernel accepted.
// The TPU kernel's separable one-hot matmuls were an MXU workaround for the
// lack of gathers; a GPU gathers directly.
//
// Rounding: px = loc_x * W - 0.5 and floor(px) are evaluated in float32 in
// that order (built with -fmad=false), exactly as the JAX `_prep` does, so
// corner indices agree at fractional and boundary locations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmemFloats = 48 * 1024 / 4;

// One bilinear corner: value times weight, or 0 outside the map (zero padding).
// kStaged rows live in shared memory; others are read through the read-only
// data path (a generic load could not use it).
template <bool kStaged>
__device__ __forceinline__ float corner(const float* s, int iy, int ix, int h, int w,
                                        float weight) {
  if (iy < 0 || iy >= h || ix < 0 || ix >= w) return 0.0f;
  return (kStaged ? s[iy * w + ix] : __ldg(s + iy * w + ix)) * weight;
}

template <bool kStaged>
__global__ void deform_scores_kernel(const float* __restrict__ scores,
                                     const float* __restrict__ loc,
                                     const float* __restrict__ aw,
                                     float* __restrict__ out, int h, int w,
                                     int d, int p) {
  extern __shared__ float smem[];
  const long long q = blockIdx.x;
  const int hw = h * w;
  const float* row = scores + q * (long long)hw;
  if (kStaged) {
    if ((hw & 3) == 0) {
      const float4* src = reinterpret_cast<const float4*>(row);
      float4* dst = reinterpret_cast<float4*>(smem);
      for (int i = threadIdx.x; i < hw / 4; i += blockDim.x) dst[i] = src[i];
    } else {
      for (int i = threadIdx.x; i < hw; i += blockDim.x) smem[i] = row[i];
    }
    __syncthreads();
    row = smem;
  }
  const float fw = (float)w, fh = (float)h;
  for (int di = threadIdx.x; di < d; di += blockDim.x) {
    const long long base = (q * d + di) * (long long)p;
    float acc = 0.0f;
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
      const float a = aw[base + pi];
      acc += corner<kStaged>(row, iy, ix, h, w, (1.0f - wx) * (1.0f - wy)) * a;
      acc += corner<kStaged>(row, iy, ix + 1, h, w, wx * (1.0f - wy)) * a;
      acc += corner<kStaged>(row, iy + 1, ix, h, w, (1.0f - wx) * wy) * a;
      acc += corner<kStaged>(row, iy + 1, ix + 1, h, w, wx * wy) * a;
    }
    out[q * d + di] = acc;
  }
}

}  // namespace

extern "C" int tp_deform_scores(const float* scores, const float* loc, const float* aw,
                                float* out, long long n_queries, int h, int w, int d, int p,
                                void* stream) {
  if (n_queries == 0) return 0;
  const int hw = h * w;
  // Stage the row when the samples touch most of its 32-byte sectors.
  const bool stage = hw <= kMaxSmemFloats && 2LL * d * p >= hw / 8;
  const int threads = d < 32 ? 32 : (d > 256 ? 256 : ((d + 31) / 32) * 32);
  if (stage) {
    deform_scores_kernel<true><<<(unsigned)n_queries, threads, (size_t)hw * sizeof(float),
                                 (cudaStream_t)stream>>>(scores, loc, aw, out, h, w, d, p);
  } else {
    deform_scores_kernel<false><<<(unsigned)n_queries, threads, 0, (cudaStream_t)stream>>>(
        scores, loc, aw, out, h, w, d, p);
  }
  return (int)cudaGetLastError();
}
