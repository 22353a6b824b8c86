// Tile compositing, backward (K4).
//
// Replaces: transplat_tpu/ops/rasterizer/pallas_composite.py
// `_composite_bwd_kernel` (the backward of `composite_pallas`).
//
// Computes, from the cotangent g = d out (B, H, W, C) of the composited image
// out = acc + T_final * background and the forward's residuals (out, T_final),
// the gradient of every tile-list entry k, summed over the tile's 256 pixels:
//   g_T       = <g, background>                    (cotangent reaching T_final)
//   total     = <g, out - T_final * background>    (= <g, acc>)
//   prefix_k  = <g, sum_{j <= k} c_j alpha_j T_j>  (running, front to back)
//   d_alpha   = <g, c_k> T_k - (total - prefix_k) / (1 - alpha_k)
//               - g_T T_final / (1 - alpha_k)      on live, kept entries, else 0
//   d_colour  = g alpha_k T_k
//   where alpha was not capped at 0.99:
//   d_opacity = d_alpha exp(power),  d_power = d_alpha alpha_k
//   d_conic   = d_power (-dx^2 / 2, -dx dy, -dy^2 / 2)
//   d_mean    = d_power (a dx + b dy, c dy + b dx)      with dx = pixel - mean
// The radius gets no gradient. 1 - alpha is clamped at 1 - 0.99 as in the TPU
// kernel. Output: d_pair (N, 8 + 4 ceil(C / 4)), one row per list entry in
// list order, columns as the geometry rows (mean x, y, conic a, b, c,
// radius = 0, opacity, pad = 0) followed by the C colours and zeros to a
// whole 16-byte vector (K2 reads and adds the row as such). Entries that come
// after their tile has saturated keep the zeros the caller put there. The
// scatter back to per-Gaussian rows is binning_bwd.cu (K2).
//
// What bounds it on an H100: operations. Every (pixel, entry) evaluation that
// the forward needed is repeated (one exp, ~60 float32 operations with the
// gradient chain) and its 6 + C values are reduced over the 256 pixels; the
// bytes are small beside that (the list features are read once per tile, the
// 32 + 4C bytes of a d_pair row are written once).
//
// Design: one block per (view, 16x16 tile), one thread per pixel, batches of
// 256 list entries staged through shared memory, exactly as the forward
// (composite.cu). Each thread walks the batch front to back and recomputes
// alpha and T with the forward's expressions in the forward's order (built
// with -fmad=false like it), so the live gate (T_before >= 1e-4) and the keep
// test flip on the same entries as in the forward. The per-pixel values of an
// entry are summed with warp shuffles (skipped when no lane of the warp
// touches the entry), the 8 warp sums land in shared memory, and after every
// 32 entries the warps' sums are added in a fixed order and written once to
// d_pair: no atomics, so the result is the same bits on every run. The block
// stops with the forward's early exit (__syncthreads_count).
//
// Not carried over from the TPU kernel: the log-space transmittance cumsum
// and the carry-free contribution cumsum on the MXU, the bf16 split matmuls,
// the paired-chunk unrolling, the fixed-capacity worklists and the quadtree
// tile order. A thread multiplies T and adds to its prefix directly.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 32;  // entries between two cross-warp sums
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTransmittanceEps = 1e-4f;

template <int C>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float* __restrict__ gfeat, const float* __restrict__ colors,
                     const int* __restrict__ idx, const int2* __restrict__ ranges,
                     const float* __restrict__ bg, const float* __restrict__ out,
                     const float* __restrict__ t_final, const float* __restrict__ gout,
                     float* __restrict__ d_pair, int g, int h, int w, int ntx, int nty) {
  constexpr int kRow = 8 + 4 * ((C + 3) / 4);  // d_pair row width
  constexpr int kVals = 6 + C;  // values a pixel contributes to an entry
  __shared__ float4 s_geo0[kThreads];  // mean x, mean y, conic a, conic b
  __shared__ float4 s_geo1[kThreads];  // conic c, radius, opacity, -
  __shared__ float s_col[kThreads * C];
  __shared__ float s_part[kWarps][kSub][kRow];

  const int tile = blockIdx.x;
  const int view = blockIdx.y;
  const int lane = threadIdx.x;
  const int warp = lane / 32;
  const int pix_x = (tile % ntx) * kTile + (lane % kTile);
  const int pix_y = (tile / ntx) * kTile + (lane / kTile);
  const float px = (float)pix_x, py = (float)pix_y;

  const int2 range = ranges[(long long)view * ntx * nty + tile];
  const float4* feat = reinterpret_cast<const float4*>(gfeat) + (long long)view * g * 2;
  const float* col = colors + (long long)view * g * C;

  // Pixels outside the image took part in the forward's early exit but wrote
  // nothing: their cotangent is 0, so everything they add below is 0.
  float go[C];
  float g_total = 0.0f, g_t = 0.0f, tfin = 0.0f;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) go[ch] = 0.0f;
  if (pix_x < w && pix_y < h) {
    const long long pixel = ((long long)view * h + pix_y) * w + pix_x;
    tfin = t_final[pixel];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float b = bg[view * C + ch];
      go[ch] = gout[pixel * C + ch];
      g_total += go[ch] * (out[pixel * C + ch] - tfin * b);
      g_t += go[ch] * b;
    }
  }
  const float gt_tfin = g_t * tfin;

  float t = 1.0f;
  float prefix = 0.0f;
  bool done = false;

  for (int start = range.x; start < range.y; start += kThreads) {
    // Doubles as the barrier that protects shared memory from the last batch.
    if (__syncthreads_count(!done) == 0) break;
    const int k = start + lane;
    if (k < range.y) {
      const int gi = idx[k];
      s_geo0[lane] = feat[2 * (long long)gi];
      s_geo1[lane] = feat[2 * (long long)gi + 1];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) s_col[lane * C + ch] = col[(long long)gi * C + ch];
    }
    __syncthreads();
    const int n = min(kThreads, range.y - start);
    for (int sub = 0; sub < n; sub += kSub) {
      const int m = min(kSub, n - sub);
      for (int jj = 0; jj < m; ++jj) {
        const int j = sub + jj;
        // v: d mean x, d mean y, d conic a, b, c, d opacity, d colours.
        float v[kVals];
#pragma unroll
        for (int i = 0; i < kVals; ++i) v[i] = 0.0f;
        bool touches = false;
        if (!done) {
          const float4 g0 = s_geo0[j];
          const float4 g1 = s_geo1[j];
          const float dx = px - g0.x;
          const float dy = py - g0.y;
          const float power = -0.5f * (g0.z * dx * dx + g1.x * dy * dy) - g0.w * dx * dy;
          const float e = expf(power);
          const float raw = g1.z * e;
          const float alpha = fminf(kAlphaMax, raw);
          if (power <= 0.0f && alpha >= kAlphaMin && dx * dx + dy * dy <= g1.y * g1.y) {
            touches = true;
            float g_dot_c = 0.0f;
#pragma unroll
            for (int ch = 0; ch < C; ++ch) g_dot_c += go[ch] * s_col[j * C + ch];
            const float weight = alpha * t;
            prefix += g_dot_c * weight;
            const float one_minus = fmaxf(1.0f - alpha, 1.0f - kAlphaMax);
            const float d_alpha =
                g_dot_c * t - (g_total - prefix) / one_minus - gt_tfin / one_minus;
#pragma unroll
            for (int ch = 0; ch < C; ++ch) v[6 + ch] = go[ch] * weight;
            if (raw < kAlphaMax) {  // a capped alpha passes nothing on
              const float d_power = d_alpha * alpha;
              v[0] = d_power * (g0.z * dx + g0.w * dy);
              v[1] = d_power * (g1.x * dy + g0.w * dx);
              v[2] = d_power * (-0.5f * dx * dx);
              v[3] = d_power * (-dx * dy);
              v[4] = d_power * (-0.5f * dy * dy);
              v[5] = d_alpha * e;
            }
            t = t * (1.0f - alpha);
            done = t < kTransmittanceEps;
          }
        }
        float* part = s_part[warp][jj];
        if (__any_sync(0xffffffffu, touches)) {
#pragma unroll
          for (int i = 0; i < kVals; ++i) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
          }
        }
        if ((lane & 31) == 0) {
          part[0] = v[0];
          part[1] = v[1];
          part[2] = v[2];
          part[3] = v[3];
          part[4] = v[4];
          part[5] = 0.0f;  // radius
          part[6] = v[5];
          part[7] = 0.0f;  // pad
#pragma unroll
          for (int ch = 0; ch < C; ++ch) part[8 + ch] = v[6 + ch];
#pragma unroll
          for (int c = 8 + C; c < kRow; ++c) part[c] = 0.0f;  // colour pad
        }
      }
      __syncthreads();
      // The 8 warp sums of each value, added in warp order, written once.
      float* rows = d_pair + (long long)(start + sub) * kRow;
      for (int i = lane; i < m * kRow; i += kThreads) {
        const int jj = i / kRow, c = i - jj * kRow;
        float sum = 0.0f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) sum += s_part[wi][jj][c];
        rows[i] = sum;
      }
      __syncthreads();
    }
  }
}

template <int C>
int launch(const float* gfeat, const float* colors, const int* idx, const int* ranges,
           const float* bg, const float* out, const float* t_final, const float* gout,
           float* d_pair, int views, int g, int h, int w, int ntx, int nty, cudaStream_t stream) {
  dim3 grid(ntx * nty, views);
  composite_bwd_kernel<C><<<grid, kThreads, 0, stream>>>(
      gfeat, colors, idx, reinterpret_cast<const int2*>(ranges), bg, out, t_final, gout, d_pair,
      g, h, w, ntx, nty);
  return (int)cudaGetLastError();
}

}  // namespace

// d_pair (N, 8 + 4 ceil(C / 4)) must arrive zeroed: rows past a tile's saturation are not written.
extern "C" int tp_composite_bwd(const float* gfeat, const float* colors, const int* idx,
                                const int* ranges, const float* bg, const float* out,
                                const float* t_final, const float* gout, float* d_pair, int views,
                                int g, int c, int h, int w, int ntx, int nty, void* stream) {
  if (views == 0 || ntx * nty == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define TP_CASE(N)                                                                             \
  case N:                                                                                      \
    return launch<N>(gfeat, colors, idx, ranges, bg, out, t_final, gout, d_pair, views, g, h, \
                     w, ntx, nty, s);
  switch (c) {
    TP_CASE(1)
    TP_CASE(2)
    TP_CASE(3)
    TP_CASE(4)
    TP_CASE(5)
    TP_CASE(6)
    TP_CASE(7)
    TP_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TP_CASE
}
