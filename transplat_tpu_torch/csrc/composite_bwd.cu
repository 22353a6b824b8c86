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
//   d_alpha   = <g, c_k> T_k - (total - prefix_k + g_T T_final) / (1 - alpha_k)
//               on live, kept entries, else 0
//   d_colour  = g alpha_k T_k
//   where alpha was not capped at 0.99:
//   d_opacity = d_alpha exp(power),  d_power = d_alpha alpha_k
//   d_conic   = d_power (-dx^2 / 2, -dx dy, -dy^2 / 2)
//   d_mean    = d_power (a dx + b dy, c dy + b dx)      with dx = pixel - mean
// The radius gets no gradient. 1 - alpha is clamped at 1 - 0.99 as in the TPU
// kernel. Output: d_pair (N, 8 + 4 ceil(C / 4)), one row per list entry in
// list order, columns as the geometry rows (mean x, y, conic a, b, c,
// radius = 0, opacity, pad = 0) followed by the C colours and zeros to a
// whole 16-byte vector (K2 reads and adds the row as such). Every row is
// written here, zeros included (entries past their tile's saturation, and
// those no pixel keeps). The scatter back to per-Gaussian rows is
// binning_bwd.cu (K2).
//
// What bounds it on an H100: issuing instructions. Every (pixel, entry)
// evaluation that the forward needed is repeated (one exp and ~20 float32
// operations), followed by the gradient chain (~25) and the sum of the row's
// values over the warp's 32 pixels; and the grid's tail, 1,024 blocks of very
// uneven work. The bytes are small beside that (the list features are read
// once per tile, a d_pair row is written once).
//
// Design: K3's walk (composite.cu, composite.cuh): one block per (view,
// 16x16 tile) taken longest list first through the forward's `order`, one thread per
// pixel, a warp on an 8x4 pixel block, batches of 256 entries in shared
// memory, each with its warp mask, and a warp walks only the entries whose
// conservative rectangle meets its pixels. Each thread recomputes alpha and T
// with the forward's expressions in the forward's order (composite::evaluate,
// built with -fmad=false like K3), so the live gate (T_before >= 1e-4) and
// the keep test flip on the same entries as in K3; fused multiply-adds and a
// fast division appear only in the gradient chain, after the gate. The row
// of a touched entry is summed over the warp by a reduce-scatter that leaves
// each sum on one lane (14 shuffles for C = 3, where a shuffle tree per value
// took 5 x (6 + C) = 45), and each warp's sums land in shared memory, zeros
// where the warp skipped the entry. After every 32 entries the 8 warps' rows are added in
// warp order and written once as 16-byte vectors: no atomics, so the result
// is the same bits on every run. The block stops with the forward's early
// exit (__syncthreads_count) and then zeroes the rows it did not reach.
//
// Not carried over from the TPU kernel: the log-space transmittance cumsum
// and the carry-free contribution cumsum on the MXU, the bf16 split matmuls,
// the paired-chunk unrolling, the fixed-capacity worklists and the quadtree
// tile order. A thread multiplies T and adds to its prefix directly.

#include "composite.cuh"

namespace {

using namespace composite;

// At most 64 registers a thread (4 resident blocks per SM): the row still
// fits in them without spills (63 for C = 3, ptxas -v).
constexpr int kMinBlocks = 4;

// Entries between two cross-warp sums: one ballot's worth (warp_entries).
constexpr int kSub = 32;

// One step of the reduce-scatter: the lanes with `upper` keep (and get the
// partner's half of) `hi`, the others `lo`.
__device__ __forceinline__ float exchange(float lo, float hi, bool upper, int off) {
  return (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, off);
}

// Sum each of x[0..N-1] (N = 8 or 16) over the warp's 32 lanes: 9 N / 8
// shuffles. Afterwards lane l holds the sums of slots base(l) + i, i < N / 8,
// base(l) = N/2 b4 + N/4 b3 + N/8 b2 (bits of l), in x[i]. Fixed order:
// deterministic.
template <int N>
__device__ __forceinline__ void reduce_scatter(float (&x)[N], int l) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x[i] = exchange(x[i], x[i + N / 2], (l & 16) != 0, 16);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) x[i] = exchange(x[i], x[i + N / 4], (l & 8) != 0, 8);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) x[i] = exchange(x[i], x[i + N / 8], (l & 4) != 0, 4);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    x[i] += __shfl_xor_sync(0xffffffffu, x[i], 2);
    x[i] += __shfl_xor_sync(0xffffffffu, x[i], 1);
  }
}

// The d_pair column of value v of an entry's row (v: d mean x, y, d conic a,
// b, c, d opacity, d colours): the radius (5) and pad (7) columns stay 0.
__host__ __device__ constexpr int column(int v) { return v < 5 ? v : (v == 5 ? 6 : v + 2); }

// kTimed: the measuring instantiation (launched only by raster_report.py)
// also writes each block's start and end time, in ns, into block_times.
template <int C, bool kTimed>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
composite_bwd_kernel(const float* __restrict__ gfeat, const float* __restrict__ colors,
                     const int* __restrict__ idx, const int2* __restrict__ ranges,
                     const int* __restrict__ order, const float* __restrict__ bg,
                     const float* __restrict__ out, const float* __restrict__ t_final,
                     const float* __restrict__ gout, float* __restrict__ d_pair, int g, int h,
                     int w, int ntx, int nty, long long* __restrict__ block_times) {
  constexpr int kRow = 8 + 4 * ((C + 3) / 4);  // d_pair row width
  constexpr int kVals = 6 + C;  // values a pixel adds to an entry's row
  // The first kRS values go through one reduce-scatter, the rest (C = 3, 4:
  // one or two) through a shuffle tree each: 14 shuffles for C = 3.
  constexpr int kRS = kVals <= 10 ? 8 : 16;
  constexpr int kTree = kVals > kRS ? kVals - kRS : 0;
  __shared__ Batch<C> s;
  __shared__ float4 s_part[kWarps][kSub * kRow / 4];  // each warp's row sums
  const long long t_start = kTimed ? global_ns() : 0;

  const int tiles = ntx * nty;
  const int cell = order != nullptr ? order[blockIdx.x] : (int)blockIdx.x;
  const int view = cell / tiles, tile = cell % tiles;
  const int lane = threadIdx.x, warp = lane / 32, l = lane % 32;
  const int ox = (tile % ntx) * kTile, oy = (tile / ntx) * kTile;
  const int2 local = pixel_of(lane);
  const int pix_x = ox + local.x, pix_y = oy + local.y;
  const float px = (float)pix_x, py = (float)pix_y;

  const int2 range = ranges[cell];
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
  // The value this lane writes after the reduce-scatter (lanes with l & 3 >=
  // kRS / 8 hold copies); lane 3 + 4 t writes tree value t.
  const int rs_value = (kRS / 2) * ((l >> 4) & 1) + (kRS / 4) * ((l >> 3) & 1) +
                       (kRS / 8) * ((l >> 2) & 1) + (l & 3);
  const bool rs_writer = (l & 3) < kRS / 8 && rs_value < kVals;
  const int tree_value = (l & 3) == 3 ? l >> 2 : kTree;

  float t = 1.0f;
  float prefix = 0.0f;
  bool done = false;

  int start = range.x;
  for (; start < range.y; start += kThreads) {
    // Doubles as the barrier that protects shared memory from the last batch.
    if (__syncthreads_count(!done) == 0) break;
    stage<C>(s, feat, col, idx, start + lane, range.y, lane, (float)ox, (float)oy);
    __syncthreads();
    const int n = min(kThreads, range.y - start);
    for (int sub = 0; sub < n; sub += kSub) {
      float* part = reinterpret_cast<float*>(s_part[warp]);
      for (int i = l; i < kSub * kRow / 4; i += 32)
        s_part[warp][i] = make_float4(0.f, 0.f, 0.f, 0.f);
      __syncwarp();
      unsigned bits = __all_sync(0xffffffffu, done) ? 0u : warp_entries<C>(s, sub, n, warp);
      while (bits) {
        const int jj = __ffs(bits) - 1;
        bits &= bits - 1;
        const int j = sub + jj;
        // x: the row's values (d mean x, y, d conic a, b, c, d opacity, d colours).
        float x[kRS + kTree];
#pragma unroll
        for (int i = 0; i < kRS + kTree; ++i) x[i] = 0.0f;
        bool touches = false;
        if (!done) {
          const float4 g0 = s.geo0[j];
          const float4 g1 = s.geo1[j];
          const Eval v = evaluate(g0, g1, px, py);
          if (v.keep) {
            touches = true;
            float g_dot_c = 0.0f;
#pragma unroll
            for (int ch = 0; ch < C; ++ch) g_dot_c = __fmaf_rn(go[ch], s.col[j * C + ch], g_dot_c);
            const float weight = v.alpha * t;
            prefix = __fmaf_rn(g_dot_c, weight, prefix);
            const float one_minus = fmaxf(1.0f - v.alpha, 1.0f - kAlphaMax);
            const float d_alpha =
                __fmaf_rn(g_dot_c, t, -__fdividef((g_total - prefix) + gt_tfin, one_minus));
#pragma unroll
            for (int ch = 0; ch < C; ++ch) x[6 + ch] = go[ch] * weight;
            if (v.raw < kAlphaMax) {  // a capped alpha passes nothing on
              const float d_power = d_alpha * v.alpha;
              x[0] = d_power * __fmaf_rn(g0.z, v.dx, g0.w * v.dy);
              x[1] = d_power * __fmaf_rn(g1.x, v.dy, g0.w * v.dx);
              x[2] = (-0.5f * d_power) * (v.dx * v.dx);
              x[3] = -d_power * (v.dx * v.dy);
              x[4] = (-0.5f * d_power) * (v.dy * v.dy);
              x[5] = d_alpha * v.e;
            }
            t = t * (1.0f - v.alpha);
            done = t < kTransmittanceEps;
          }
        }
        if (__any_sync(0xffffffffu, touches)) {
          reduce_scatter<kRS>(*reinterpret_cast<float(*)[kRS]>(x), l);
#pragma unroll
          for (int i = kRS; i < kRS + kTree; ++i) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) x[i] += __shfl_xor_sync(0xffffffffu, x[i], off);
          }
          if (rs_writer)
            part[jj * kRow + column(rs_value)] = (kRS == 16 && (l & 1)) ? x[1] : x[0];
#pragma unroll
          for (int i = 0; i < kTree; ++i)
            if (tree_value == i) part[jj * kRow + column(kRS + i)] = x[kRS + i];
        }
      }
      __syncthreads();
      // The 8 warp sums of each value, added in warp order, written once.
      const int m = min(kSub, n - sub);
      float4* rows = reinterpret_cast<float4*>(d_pair + (long long)(start + sub) * kRow);
      for (int i = lane; i < m * kRow / 4; i += kThreads) {
        float4 sum = s_part[0][i];
#pragma unroll
        for (int wi = 1; wi < kWarps; ++wi) {
          const float4 p = s_part[wi][i];
          sum.x += p.x;
          sum.y += p.y;
          sum.z += p.z;
          sum.w += p.w;
        }
        rows[i] = sum;
      }
      __syncthreads();
    }
  }
  // Rows of the batches the early exit skipped.
  for (int k = start + lane; k < range.y; k += kThreads) {
    float4* row = reinterpret_cast<float4*>(d_pair + (long long)k * kRow);
#pragma unroll
    for (int q = 0; q < kRow / 4; ++q) row[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (kTimed) {
    __syncthreads();
    if (lane == 0) {
      block_times[2 * (long long)cell] = t_start;
      block_times[2 * (long long)cell + 1] = global_ns();
    }
  }
}

template <int C>
int launch(const float* gfeat, const float* colors, const int* idx, const int* ranges,
           const int* order, const float* bg, const float* out, const float* t_final,
           const float* gout, float* d_pair, int views, int g, int h, int w, int ntx, int nty,
           long long* block_times, cudaStream_t stream) {
  const int cells = views * ntx * nty;
  const int2* r = reinterpret_cast<const int2*>(ranges);
  if (block_times != nullptr)
    composite_bwd_kernel<C, true><<<cells, kThreads, 0, stream>>>(
        gfeat, colors, idx, r, order, bg, out, t_final, gout, d_pair, g, h, w, ntx, nty,
        block_times);
  else
    composite_bwd_kernel<C, false><<<cells, kThreads, 0, stream>>>(
        gfeat, colors, idx, r, order, bg, out, t_final, gout, d_pair, g, h, w, ntx, nty, nullptr);
  return (int)cudaGetLastError();
}

template <int C>
int attributes(int* info) {
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, composite_bwd_kernel<C, false>);
  if (err) return err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[3], composite_bwd_kernel<C, false>, kThreads, 0);
}

}  // namespace

#define TP_CHANNELS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

// d_pair (N, 8 + 4 ceil(C / 4)), 16-byte aligned: every row is written.
// order: null (the cells in their own order) or (views * ntx * nty,) int32, the cells in
// launch order (a permutation).
// block_times: null on the main path; else (views * ntx * nty, 2) int64 for the measuring launch.
extern "C" int tp_composite_bwd(const float* gfeat, const float* colors, const int* idx,
                                const int* ranges, const int* order, const float* bg,
                                const float* out, const float* t_final, const float* gout,
                                float* d_pair, int views, int g, int c, int h, int w, int ntx,
                                int nty, long long* block_times, void* stream) {
  if (views == 0 || ntx * nty == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define TP_CASE(N)                                                                               \
  case N:                                                                                        \
    return launch<N>(gfeat, colors, idx, ranges, order, bg, out, t_final, gout, d_pair, views, \
                     g, h, w, ntx, nty, block_times, s);
  switch (c) {
    TP_CHANNELS(TP_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TP_CASE
}

// info: registers, static shared bytes, local bytes, resident blocks per SM.
extern "C" int tp_composite_bwd_attributes(int c, int* info) {
#define TP_CASE(N) \
  case N: return attributes<N>(info);
  switch (c) {
    TP_CHANNELS(TP_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TP_CASE
}
