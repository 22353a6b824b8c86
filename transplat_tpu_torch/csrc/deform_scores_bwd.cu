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
// Design (rows that fit in shared memory; every shape of the paths):
//   * The gradient row is summed as fixed-point integers in shared memory:
//     each corner adds round(s * w_corner * 2^e) with native 32-bit integer
//     atomics (two words a cell, see `kLoBits`; a 64-bit shared-memory add
//     is a compare-and-swap loop on this card), e chosen per query from the
//     largest |gbar * aw| so that no sum overflows. Integer adds do not
//     depend on their order, so d_scores has the same bits on every run,
//     with or without trainer.deterministic_kernels; each add is exact to
//     2^-40 of the query's largest contribution at D P = 512, finer than the
//     float32 rounding of the sums it replaces. A query whose d out or
//     weights are not finite gets a NaN row.
//   * Where the samples touch most of the score row (16 D P >= H W, as K5;
//     P = 4 on the path) the row is staged: persistent blocks of 4 warps
//     walk the queries blockIdx.x, + gridDim.x, ..., with a two-stage ring
//     in shared memory, each stage filled by one bulk asynchronous copy
//     (cp.async.bulk, the TMA's 1D form) that completes on an mbarrier. The
//     next query's row loads while the block samples the current one, and
//     the corners read shared memory. Otherwise (P = 1) a block of 8 warps
//     takes one query and reads the corners from device memory through the
//     read-only path, so only the touched sectors move.
//   * Lanes take neighbouring (d, p) samples, so loc / d_loc move as float2
//     and loc, aw, d_loc, d_aw coalesce; a thread loads its samples (4 at
//     P = 4) together, and the next query's while the row is written out.
//   * After a barrier the block converts the row to float32, writes it with
//     16-byte stores (every value: no zero fill) and zeroes the cells that
//     took an add.
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

constexpr unsigned kFull = 0xffffffffu;
// Paths (the Python wrapper picks one: ops/deform.py `scores_bwd_plan`).
constexpr int kGeneral = 0, kDirect = 1, kStaged = 2;
constexpr int kMaxDynamicSmem = 227 * 1024 - 1024;  // beside the static shared memory

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

// Thread 0: copy `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One sample's corner geometry: the top-left corner (clamped so that the
// integer conversion is defined far outside the map), the fractions, and
// which of the four corners lie inside the map.
struct Corners {
  int ix, iy;
  float wx, wy;
  bool in00, in01, in10, in11;
};

__device__ __forceinline__ Corners corners_of(float2 l, int h, int w) {
  const float fw = (float)w, fh = (float)h;
  const float px = l.x * fw - 0.5f;
  const float py = l.y * fh - 0.5f;
  float x0 = floorf(px);
  float y0 = floorf(py);
  Corners c;
  c.wx = px - x0;
  c.wy = py - y0;
  x0 = fminf(fmaxf(x0, -2.0f), fw + 1.0f);
  y0 = fminf(fmaxf(y0, -2.0f), fh + 1.0f);
  c.ix = (int)x0;
  c.iy = (int)y0;
  const bool in_x0 = c.ix >= 0 && c.ix < w, in_x1 = c.ix + 1 >= 0 && c.ix + 1 < w;
  const bool in_y0 = c.iy >= 0 && c.iy < h, in_y1 = c.iy + 1 >= 0 && c.iy + 1 < h;
  c.in00 = in_y0 && in_x0;
  c.in01 = in_y0 && in_x1;
  c.in10 = in_y1 && in_x0;
  c.in11 = in_y1 && in_x1;
  return c;
}

template <bool kShared>
__device__ __forceinline__ float read(const float* row, int i) {
  return kShared ? row[i] : __ldg(row + i);
}

// The sample's d_aw and d_loc (written here) and its four gradient-row
// contributions (cell, value), cell -1 for a corner outside the map.
template <bool kShared>
__device__ __forceinline__ void sample_grads(const float* row, float2 l, float a, float gb, int h, int w,
                                             float* d_aw, float2* d_loc, int cell[4], float val[4]) {
  const Corners c = corners_of(l, h, w);
  const int i00 = c.iy * w + c.ix;
  const float v00 = c.in00 ? read<kShared>(row, i00) : 0.0f;
  const float v01 = c.in01 ? read<kShared>(row, i00 + 1) : 0.0f;
  const float v10 = c.in10 ? read<kShared>(row, i00 + w) : 0.0f;
  const float v11 = c.in11 ? read<kShared>(row, i00 + w + 1) : 0.0f;
  const float wx = c.wx, wy = c.wy;
  const float w00 = (1.0f - wx) * (1.0f - wy), w01 = wx * (1.0f - wy);
  const float w10 = (1.0f - wx) * wy, w11 = wx * wy;
  const float s = gb * a;
  *d_aw = gb * (v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11);
  *d_loc = make_float2(s * (float)w * ((1.0f - wy) * (v01 - v00) + wy * (v11 - v10)),
                       s * (float)h * ((1.0f - wx) * (v10 - v00) + wx * (v11 - v01)));
  cell[0] = c.in00 ? i00 : -1;
  cell[1] = c.in01 ? i00 + 1 : -1;
  cell[2] = c.in10 ? i00 + w : -1;
  cell[3] = c.in11 ? i00 + w + 1 : -1;
  val[0] = s * w00;
  val[1] = s * w01;
  val[2] = s * w10;
  val[3] = s * w11;
}

// A gradient row holds each cell's sum as a fixed-point integer v in units
// of 2^-e, split v = hi 2^kLoBits + lo (0 <= lo < 2^kLoBits) into two 32-bit
// words that each take native shared-memory integer adds (a 64-bit add is a
// compare-and-swap loop on this card). The low words take up to
// 2^(32 - kLoBits) adds without a carry out, and e keeps |v| below
// 2^kFixedBits: with every |gbar * aw| of the query below 2^k and at most 2^L
// samples, e = kFixedBits - k - L. Integer adds do not depend on their
// order, so the row has the same bits on every run.
constexpr int kLoBits = 20;
constexpr int kFixedBits = kLoBits + 30;
constexpr int kMaxSamples = 1 << (32 - kLoBits);  // D P of a query, at most

__device__ __forceinline__ float exp2i(int n) { return __int_as_float((n + 127) << 23); }  // 2^n, |n| < 127

struct Scale {
  int e;
  float up1, up2, down1, down2;  // 2^e and 2^-e, each as two exact factors
};

__device__ __forceinline__ Scale make_scale(float max_abs, int dp) {
  Scale sc;
  sc.e = 0;
  if (max_abs > 0.0f) {
    int k;
    frexpf(max_abs, &k);
    sc.e = kFixedBits - k - (dp > 1 ? 32 - __clz(dp - 1) : 0);
  }
  const int e1 = sc.e >> 1, e2 = sc.e - e1;
  sc.up1 = exp2i(e1);
  sc.up2 = exp2i(e2);
  sc.down1 = exp2i(-e1);
  sc.down2 = exp2i(-e2);
  return sc;
}

__device__ __forceinline__ void add_fixed(unsigned* hi, unsigned* lo, int cell, float v, const Scale& sc) {
  const long long x = __float2ll_rn(v * sc.up1 * sc.up2);
  atomicAdd(hi + cell, (unsigned)(int)(x >> kLoBits));
  atomicAdd(lo + cell, (unsigned)(x & ((1LL << kLoBits) - 1)));
}

__device__ __forceinline__ float read_fixed(unsigned hi, unsigned lo, const Scale& sc) {
  const long long x = ((long long)(int)hi << kLoBits) + (long long)lo;
  return __ll2float_rn(x) * sc.down1 * sc.down2;
}

// Threads of a block: 4 warps staged (3 blocks fit on an SM at 64x64), 8
// direct, so that enough loads are in flight.
template <bool kStaged>
__host__ __device__ constexpr int block_threads() {
  return kStaged ? 128 : 256;
}

// kStaged: the score row comes through the shared-memory ring (h * w % 4 == 0,
// scores 16-byte aligned); otherwise the corners are read from device memory.
template <bool kStaged>
__global__ void __launch_bounds__(block_threads<kStaged>()) deform_scores_bwd_kernel(
    const float* __restrict__ scores, const float2* __restrict__ loc, const float* __restrict__ aw,
    const float* __restrict__ gbar, float* __restrict__ d_scores, float2* __restrict__ d_loc,
    float* __restrict__ d_aw, long long n_queries, int h, int w, int d, int p) {
  constexpr int kThreads = block_threads<kStaged>(), kWarps = kThreads / 32;
  constexpr int kBatch = kStaged ? 4 : 1;  // samples a thread loads at once (512 or 256 a block)
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ float s_max[2][kWarps];  // per warp, the largest |gbar * aw| of this query and the next
  const int hw = h * w;
  const int hw_pad = (hw + 3) & ~3;  // every row 16-byte aligned
  float* stage = smem;
  unsigned* hi = reinterpret_cast<unsigned*>(smem + (kStaged ? 2 * hw_pad : 0));
  unsigned* lo = hi + hw_pad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp = d * p;

  const unsigned row_bytes = (unsigned)hw * 4u;
  long long q = blockIdx.x;

  // kBatch samples of a thread (from j0 on, kThreads apart), loaded together.
  float2 l[kBatch];
  float a[kBatch], gb[kBatch];
  auto load_batch = [&](long long qq, int j0) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads;
      const bool live = j < dp;
      l[u] = live ? __ldg(loc + qq * dp + j) : make_float2(0.0f, 0.0f);
      a[u] = live ? __ldg(aw + qq * dp + j) : 0.0f;
      gb[u] = live ? __ldg(gbar + qq * d + j / p) : 0.0f;
    }
  };
  // The warp's largest |gbar * aw| of query qq (NaN if one is not finite)
  // into s_max[slot], from the first batch in registers and the rest of the
  // query's samples; the block reads it after the next barrier.
  auto publish_max = [&](long long qq, int slot) {
    float m = 0.0f;
    bool finite = true;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float x = fabsf(gb[u] * a[u]);
      finite &= x <= 3.402823466e38f;
      m = fmaxf(m, x);
    }
    for (int j = threadIdx.x + kBatch * kThreads; j < dp; j += kThreads) {
      const float x = fabsf(__ldg(gbar + qq * d + j / p) * __ldg(aw + qq * dp + j));
      finite &= x <= 3.402823466e38f;
      m = fmaxf(m, x);
    }
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    finite = __all_sync(kFull, finite);
    if (lane == 0) s_max[slot][warp] = finite ? m : __int_as_float(0x7fc00000);
  };
  if (q < n_queries) {
    load_batch(q, threadIdx.x);
    publish_max(q, 0);
  }
  for (int i = threadIdx.x; i < 2 * hw_pad; i += kThreads) hi[i] = 0u;
  if (kStaged && threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();  // one barrier: the zeroed row, the barriers and the first scale
  if (kStaged && threadIdx.x == 0 && q < n_queries) bulk_load(stage, scores + q * hw, row_bytes, &bar[0]);

  for (int it = 0; q < n_queries; ++it, q += gridDim.x) {
    const long long base = q * (long long)dp;
    const float* row = scores + q * (long long)hw;
    if (kStaged) {
      const int s = it & 1;
      const long long next = q + gridDim.x;
      // The other stage was last read before the previous iteration's final barrier.
      if (threadIdx.x == 0 && next < n_queries)
        bulk_load(stage + (s ^ 1) * hw_pad, scores + next * hw, row_bytes, &bar[s ^ 1]);
      mbar_wait(&bar[s], (unsigned)(it >> 1) & 1u);
      row = stage + s * hw_pad;
    }
    // The row's scale, published before the last barrier.
    float row_max = 0.0f;
    bool row_finite = true;
    for (int i = 0; i < kWarps; ++i) {
      const float m = s_max[it & 1][i];
      row_finite &= m == m;
      row_max = fmaxf(row_max, m);
    }
    const Scale sc = make_scale(row_finite ? row_max : 0.0f, dp);

    for (int j0 = threadIdx.x; j0 < dp; j0 += kBatch * kThreads) {
      if (j0 != threadIdx.x) load_batch(q, j0);  // the first batch is loaded already
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * kThreads;
        if (j >= dp) break;
        int cell[4];
        float val[4];
        float daw;
        float2 dl;
        sample_grads<kStaged>(row, l[u], a[u], gb[u], h, w, &daw, &dl, cell, val);
        d_aw[base + j] = daw;
        d_loc[base + j] = dl;
        if (row_finite) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (cell[c] >= 0) add_fixed(hi, lo, cell[c], val[c], sc);
        }
      }
    }
    // The next query's first batch and scale, while this row is written.
    if (q + gridDim.x < n_queries) {
      load_batch(q + gridDim.x, threadIdx.x);
      publish_max(q + gridDim.x, (it + 1) & 1);
    }
    __syncthreads();
    // The row -> d_scores (NaN where a d out or weight of the query was not
    // finite); zero it where the block takes another query.
    float* out = d_scores + q * (long long)hw;
    const float nan = __int_as_float(0x7fc00000);
    const bool again = q + gridDim.x < n_queries;
    if ((hw & 3) == 0) {
      uint4* hi4 = reinterpret_cast<uint4*>(hi);
      uint4* lo4 = reinterpret_cast<uint4*>(lo);
      for (int i = threadIdx.x; i < hw / 4; i += kThreads) {
        const uint4 x = hi4[i], y = lo4[i];
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if ((x.x | x.y | x.z | x.w | y.x | y.y | y.z | y.w) != 0u) {  // most cells take no sample
          if (again) hi4[i] = lo4[i] = make_uint4(0u, 0u, 0u, 0u);
          v = make_float4(read_fixed(x.x, y.x, sc), read_fixed(x.y, y.y, sc), read_fixed(x.z, y.z, sc),
                          read_fixed(x.w, y.w, sc));
        }
        reinterpret_cast<float4*>(out)[i] = row_finite ? v : make_float4(nan, nan, nan, nan);
      }
    } else {
      for (int i = threadIdx.x; i < hw; i += kThreads) {
        out[i] = row_finite ? read_fixed(hi[i], lo[i], sc) : nan;
        if (again) hi[i] = lo[i] = 0u;
      }
    }
    __syncthreads();
  }
}

// The general path: one block per query, atomic adds into the zeroed d_scores.
__global__ void deform_scores_bwd_general_kernel(const float* __restrict__ scores,
                                                 const float2* __restrict__ loc,
                                                 const float* __restrict__ aw,
                                                 const float* __restrict__ gbar, float* d_scores,
                                                 float2* __restrict__ d_loc, float* __restrict__ d_aw,
                                                 int h, int w, int d, int p) {
  const long long q = blockIdx.x;
  const int dp = d * p;
  const float* row = scores + q * (long long)h * w;
  float* d_row = d_scores + q * (long long)h * w;
  for (int j = threadIdx.x; j < dp; j += blockDim.x) {
    const long long e = q * dp + j;
    int cell[4];
    float val[4];
    float daw;
    float2 dl;
    sample_grads<false>(row, __ldg(loc + e), __ldg(aw + e), __ldg(gbar + q * d + j / p), h, w, &daw, &dl, cell,
                        val);
    d_aw[e] = daw;
    d_loc[e] = dl;
    for (int c = 0; c < 4; ++c)
      if (cell[c] >= 0) atomicAdd(d_row + cell[c], val[c]);
  }
}

template <typename Kernel>
int launch_rows(Kernel kernel, int threads, bool persistent, size_t smem, long long n_queries, cudaStream_t s,
                const float* scores, const float* loc, const float* aw, const float* gbar, float* d_scores,
                float* d_loc, float* d_aw, int h, int w, int d, int p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // Staged: persistent blocks, as many as stay resident (the ring needs the
  // next query). Direct: a block per query, in waves (two or four queries a
  // block read slower at the path's P = 1).
  const long long resident = (long long)sms * per_sm;
  const unsigned blocks = (unsigned)(persistent && resident < n_queries ? resident : n_queries);
  kernel<<<blocks, threads, smem, s>>>(scores, reinterpret_cast<const float2*>(loc), aw, gbar, d_scores,
                                        reinterpret_cast<float2*>(d_loc), d_aw, n_queries, h, w, d, p);
  return (int)cudaGetLastError();
}

int launch_path(bool staged, long long n_queries, cudaStream_t s, const float* scores, const float* loc,
                const float* aw, const float* gbar, float* d_scores, float* d_loc, float* d_aw, int h, int w, int d,
                int p) {
  const long long hw_pad = ((long long)h * w + 3) & ~3LL;
  const size_t smem = (size_t)hw_pad * ((staged ? 2 : 0) + 2) * sizeof(float);
  if (smem > (size_t)kMaxDynamicSmem || (long long)d * p > kMaxSamples) return (int)cudaErrorInvalidValue;
  if (staged)
    return launch_rows(deform_scores_bwd_kernel<true>, block_threads<true>(), true, smem, n_queries, s, scores,
                       loc, aw, gbar, d_scores, d_loc, d_aw, h, w, d, p);
  return launch_rows(deform_scores_bwd_kernel<false>, block_threads<false>(), false, smem, n_queries, s, scores,
                     loc, aw, gbar, d_scores, d_loc, d_aw, h, w, d, p);
}

}  // namespace

// scores (n_queries, h * w), loc (n_queries, d, p, 2) 8-byte aligned, aw
// (n_queries, d, p), gbar (n_queries, d), float32 and contiguous. Every value
// of d_scores, d_loc and d_aw is written. `path`: 2 staged (h * w % 4 == 0,
// scores 16-byte aligned), 1 direct, 0 general (d_scores zeroed here first, on
// the same stream; its last bits vary from run to run). Paths 1 and 2 take
// d * p <= 4096.
extern "C" int tp_deform_scores_bwd(const float* scores, const float* loc, const float* aw,
                                    const float* gbar, float* d_scores, float* d_loc, float* d_aw,
                                    long long n_queries, int h, int w, int d, int p, int path, void* stream) {
  if (n_queries == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long hw = (long long)h * w;
  if (path == kGeneral) {
    const cudaError_t err = cudaMemsetAsync(d_scores, 0, (size_t)(n_queries * hw) * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    if (d * p == 0) return 0;
    const int threads = d * p < 32 ? 32 : (d * p > 256 ? 256 : ((d * p + 31) / 32) * 32);
    deform_scores_bwd_general_kernel<<<(unsigned)n_queries, threads, 0, s>>>(
        scores, reinterpret_cast<const float2*>(loc), aw, gbar, d_scores, reinterpret_cast<float2*>(d_loc), d_aw,
        h, w, d, p);
    return (int)cudaGetLastError();
  }
  const bool staged = path == kStaged;
  if ((path != kDirect && !staged) || (staged && ((hw & 3) != 0 || (uintptr_t)scores % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  return launch_path(staged, n_queries, s, scores, loc, aw, gbar, d_scores, d_loc, d_aw, h, w, d, p);
}
