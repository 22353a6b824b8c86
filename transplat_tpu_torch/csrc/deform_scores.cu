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
// is negligible. At P = 1 the scattered corner reads dominate, and they run
// at ~1.7x the time their 32-byte sectors would take at full rate (the
// timings fit whole 64-byte granules moving per scattered access).
// grid_sample pays the same but reads no weight (4 of the 16 bytes per
// sample beside the corners).
//
// Design, one kernel in two modes:
//   * direct (the samples touch less than the row, P = 1 on the path): one
//     thread per output (query, slot) over a flat index (32-bit division
//     where it fits), 256 threads a block, so a block serves 256 / D
//     queries; a location is one 8-byte load, and the corners are
//     read straight from device memory through the read-only path, so only
//     the granules that the samples touch move. The first design spent a
//     128-thread block and two 4-byte location loads on every query and
//     read 0.033 ms against grid_sample's 0.030.
//   * staged (the samples touch at least as many sectors as the row holds,
//     P = 4 on the path): persistent blocks, one per resident slot, each
//     walking the queries blockIdx.x, + gridDim.x, ...; two row buffers in
//     shared memory, and the next query's row is copied with cp.async
//     (16 bytes a thread, L2 to shared memory without registers) while the
//     block samples the current one from the other. Each score byte leaves
//     device memory once and its load overlaps the sampling; the first
//     design loaded a row, waited at a barrier, then sampled, once per query.
// Every shape is covered, not only the ones the TPU kernel accepted. The TPU
// kernel's separable one-hot matmuls were an MXU workaround for the lack of
// gathers; a GPU gathers directly.
//
// Rounding: px = loc_x * W - 0.5 and floor(px) are evaluated in float32 in
// that order (built with -fmad=false), exactly as the JAX `_prep` does, so
// corner indices agree at fractional and boundary locations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmemBytes = 48 * 1024;
constexpr int kDirectThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// One bilinear corner: value times weight, or 0 outside the map (zero padding).
// kStaged rows live in shared memory; others are read through the read-only
// data path (a generic load could not use it).
template <bool kStaged>
__device__ __forceinline__ float corner(const float* s, int iy, int ix, int h, int w,
                                        float weight) {
  if (iy < 0 || iy >= h || ix < 0 || ix >= w) return 0.0f;
  return (kStaged ? s[iy * w + ix] : __ldg(s + iy * w + ix)) * weight;
}

// out[q, slot] for one query's row: the P weighted bilinear samples of the slot.
template <bool kStaged>
__device__ __forceinline__ float sample_slot(const float* row, const float2* __restrict__ loc,
                                             const float* __restrict__ aw, int p, int h, int w) {
  const float fw = (float)w, fh = (float)h;
  float acc = 0.0f;
  for (int pi = 0; pi < p; ++pi) {
    const float2 l = __ldg(loc + pi);
    const float a = __ldg(aw + pi);
    float px = l.x * fw - 0.5f;
    float py = l.y * fh - 0.5f;
    float x0 = floorf(px);
    float y0 = floorf(py);
    const float wx = px - x0;
    const float wy = py - y0;
    // Far outside the map every corner is padding; clamping the integer
    // corner keeps the conversion defined without changing the result.
    x0 = fminf(fmaxf(x0, -2.0f), fw + 1.0f);
    y0 = fminf(fmaxf(y0, -2.0f), fh + 1.0f);
    const int ix = (int)x0, iy = (int)y0;
    acc += corner<kStaged>(row, iy, ix, h, w, (1.0f - wx) * (1.0f - wy)) * a;
    acc += corner<kStaged>(row, iy, ix + 1, h, w, wx * (1.0f - wy)) * a;
    acc += corner<kStaged>(row, iy + 1, ix, h, w, (1.0f - wx) * wy) * a;
    acc += corner<kStaged>(row, iy + 1, ix + 1, h, w, wx * wy) * a;
  }
  return acc;
}

// kStaged: persistent blocks with two row buffers (hw % 4 == 0, 16-byte
// aligned scores). Otherwise: one thread per output of the flat index.
template <bool kStaged>
__global__ void deform_scores_kernel(const float* __restrict__ scores,
                                     const float2* __restrict__ loc,
                                     const float* __restrict__ aw,
                                     float* __restrict__ out, long long n_queries, int h,
                                     int w, int d, int p, bool index32) {
  const int hw = h * w;
  if constexpr (kStaged) {
    extern __shared__ float4 smem[];
    const int hw4 = hw / 4;
    const auto stage = [&](long long q, int buf) {  // one commit group per call
      const float4* src = reinterpret_cast<const float4*>(scores + q * hw);
      for (int i = threadIdx.x; i < hw4; i += blockDim.x) cp_async16(smem + buf * hw4 + i, src + i);
      cp_async_commit();
    };
    long long q = blockIdx.x;
    if (q < n_queries) stage(q, 0);
    for (int it = 0; q < n_queries; q += gridDim.x, ++it) {
      const long long next = q + gridDim.x;
      if (next < n_queries) {
        stage(next, (it + 1) & 1);  // the buffer the last query used, freed by its closing barrier
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* row = reinterpret_cast<const float*>(smem + (it & 1) * hw4);
      for (int di = threadIdx.x; di < d; di += blockDim.x) {
        const long long slot = q * d + di;
        out[slot] = sample_slot<true>(row, loc + slot * p, aw + slot * p, p, h, w);
      }
      __syncthreads();
    }
  } else {
    const long long slot = blockIdx.x * (long long)kDirectThreads + threadIdx.x;
    if (slot >= n_queries * d) return;
    const long long q = index32 ? (long long)((unsigned)slot / (unsigned)d) : slot / d;
    out[slot] = sample_slot<false>(scores + q * hw, loc + slot * p, aw + slot * p, p, h, w);
  }
}

}  // namespace

// scores (n_queries, h * w), loc (n_queries, d, p, 2) 8-byte aligned, aw (n_queries, d, p),
// out (n_queries, d).
extern "C" int tp_deform_scores(const float* scores, const float* loc, const float* aw,
                                float* out, long long n_queries, int h, int w, int d, int p,
                                void* stream) {
  if (n_queries == 0 || d == 0) return 0;
  if (reinterpret_cast<uintptr_t>(loc) & 7) return (int)cudaErrorMisalignedAddress;
  const int hw = h * w;
  const size_t row_bytes = (size_t)hw * sizeof(float);
  const float2* loc2 = reinterpret_cast<const float2*>(loc);
  cudaStream_t s = (cudaStream_t)stream;
  // Stage the rows when the samples touch most of their 32-byte sectors and
  // two of them fit the default shared memory.
  const bool stage = 2 * row_bytes <= kMaxSmemBytes && (hw & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(scores) & 15) == 0 && 2LL * d * p >= hw / 8;
  if (stage) {
    const int threads = d < 32 ? 32 : (d > 256 ? 256 : ((d + 31) / 32) * 32);
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, deform_scores_kernel<true>, threads, 2 * row_bytes);
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const unsigned blocks = (unsigned)(n_queries < resident ? n_queries : resident);
    deform_scores_kernel<true><<<blocks, threads, 2 * row_bytes, s>>>(scores, loc2, aw, out, n_queries, h, w, d, p, false);
  } else {
    const long long outputs = n_queries * d;
    const unsigned blocks = (unsigned)((outputs + kDirectThreads - 1) / kDirectThreads);
    deform_scores_kernel<false><<<blocks, kDirectThreads, 0, s>>>(scores, loc2, aw, out, n_queries, h, w, d, p,
                                                                 outputs < (1LL << 32));
  }
  return (int)cudaGetLastError();
}
