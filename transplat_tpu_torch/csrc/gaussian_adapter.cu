// The encoder's Gaussian adapter stage, forward, as one kernel.
//
// Replaces no TPU kernel. The JAX package leaves this stage
// (transplat_tpu/model/adapter.py `adapt_gaussians`, with the pixel offsets and
// the opacity of transplat_tpu/model/encoder.py) to XLA, which fuses it. Run
// eagerly, its plain PyTorch version (transplat_tpu_torch/model/encoder.py
// `adapt_stage_plain`) dispatches ~5,300 ops a request: the SH
// rotation's Ivanic-Ruedenberg recursion alone builds the 155 entries of the
// degree 2-4 matrices one scalar op at a time on per-camera tensors. Its cost
// was host time, not device time.
//
// Computes, for every Gaussian (sample k of pixel p of view v of batch entry
// b; a pixel has S samples, each with its own depth and density, and shares
// its raw channels among them), what the plain version computes, in float32
// and in its order of operations:
//   * the ray coordinate: the pixel centre plus (sigmoid(raw[0:2]) - 0.5) times
//     the pixel size;
//   * the opacity: map_pdf_to_opacity of the density with the warm-up's
//     exponent, over the Gaussians a pixel;
//   * the scales: smin + (smax - smin) sigmoid(raw[2:5]), times the depth, times
//     the camera's pixel-size multiplier 0.1 sum(K2x2^-1 (1/W, 1/H));
//   * the normalised quaternion raw[5:9] (xyzw) and the world covariance
//     C R diag(s^2) R^T C^T (C: the camera-to-world rotation);
//   * the world ray (origin, unit direction K^-1 (x, y, 1), rotated by C) and
//     the mean origin + direction * depth;
//   * the SH raw[9:] as (3, d_sh), damped per degree, then rotated block by
//     block by the camera's degree 1..4 real-SH rotation matrices.
// The results land in the layouts the Gaussians hold, in (view, pixel, sample)
// order: means (b, v r S, 3), covariances (b, v r S, 3, 3), harmonics
// (b, v r S, 3, d_sh), opacities (b, v r S), and, where asked for, scales
// (b, v r S, 3) and rotations (b, v r S, 4).
//
// What bounds it on an H100: device-memory bytes. A Gaussian reads 86 floats
// (84 raw channels at SH degree 4, its depth and density) and writes 88 (95
// with scales and rotations): 91 MB for 131,072 Gaussians, 27 us at 3.35 TB/s.
// Its ~1,100 flops a Gaussian (the SH rotation's 495 products and sums, the
// covariance's three 3x3 products) are a few us at 67 TFLOP/s.
//
// Design: a block of kTile threads takes kTile consecutive pixels of one
// camera (grid: pixel tiles x b v), one pixel a thread: its S Gaussians come
// from one read of its raw channels.
//   * The per-camera prologue is the block's own: K^-1 and K2x2^-1 by their
//     adjugates in double (no torch.linalg.inv, so no host synchronisation),
//     the multiplier, C and the origin, and the SH rotation matrices D_1..D_4
//     (164 floats) in shared memory, one entry a thread, a barrier between
//     degrees (D_l needs D_(l-1)). It is a few thousand flops; each thread
//     first issues the loads of its own Gaussian's geometry inputs, so the
//     prologue overlaps them.
//   * Reads: the channels are read with the strides the caller gives. The
//     encoder's raw tensor is its 1x1 convolution's NCHW output viewed as
//     (b, v, H W, channels): one channel of consecutive pixels is contiguous,
//     so a warp's read of a channel is one 128-byte line.
//   * Writes: the outputs are rows (75 SH floats a Gaussian), so one thread a
//     row would store 32 lines a warp instruction. Each block stages its rows
//     in shared memory (SH: kTile x 75 floats, 38.4 KB; a row stride of 75 is
//     odd, so a warp's writes hit 32 banks) and stores them as one contiguous
//     run, consecutive threads on consecutive float4s where the run starts
//     16-byte aligned (on the encoder's path it does), else floats.
//   * Measured (H100, 700 W): 0.0615 ms at 131,072 Gaussians, 44% of the
//     byte bound; the float4 stores took 2% off the float stores' 0.0630.
//     A thread reads its 75 SH channels in 15 groups with the products
//     between them, and 5 blocks fit an SM (shared memory): too few loads in
//     flight, rather than the stores, look like the limit (no profiler
//     counters on that machine to confirm it).
//   * S > 1 (pixelSplat's three depths a pixel): the ray, the quaternion and
//     the rotated SH are computed once a pixel; the geometry is staged and
//     stored once a sample, each sample's rows at stride S rows, and the SH
//     row is stored S times. S = 1 is an instantiation of its own (kSamples
//     false: S the constant 1, the contiguous runs above), the kernel as it
//     was before it took samples.
//   * Rounding: built with -fmad=false, like every kernel here, so no product
//     and sum contract; sums run left to right, as the plain version's small
//     matmuls do up to their library's order (the card tests hold it to 1e-5).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kGeomFloats = 19;  // means 3, covariance 9, scales 3, rotation 4
// Shared-memory floats of the per-camera values: K^-1 (9), C (9), origin (3), multiplier (1).
constexpr int kCamFloats = 22;

struct Args {
  const float* raw;
  const float* depth;
  const float* density;
  const float* intr;
  const float* extr;
  float* means;
  float* cov;
  float* harm;
  float* opac;
  float* scales;  // or null
  float* rots;    // or null
  int v, h, w;
  long long s_b, s_v, s_p, s_c;
  float scale_min, scale_range;
  double exponent, inv_exponent;
  int gaussians_per_pixel;
  int samples;
};

// Offset of D_l in the per-camera table: D_1 at 0, D_2 at 9, D_3 at 34, D_4 at 83.
__host__ __device__ constexpr int d_offset(int l) { return l <= 1 ? 0 : d_offset(l - 1) + (2 * l - 1) * (2 * l - 1); }

// The damping of degree l: 0.1 * 0.25^l, in double and then float32, as the
// plain version builds its mask from Python floats.
__host__ __device__ constexpr float sh_damping(int l) {
  double p = 1.0;
  for (int i = 0; i < l; ++i) p *= 0.25;
  return l == 0 ? 1.0f : (float)(0.1 * p);
}

// Stores n floats of shared memory at dst, consecutive threads on
// consecutive floats: as float4 where dst is 16-byte aligned (src is).
__device__ __forceinline__ void store_run(float* __restrict__ dst, const float* src, int n, int t) {
  if (((uintptr_t)dst & 15) == 0) {
    const int n4 = n >> 2;
    for (int k = t; k < n4; k += kTile) reinterpret_cast<float4*>(dst)[k] = reinterpret_cast<const float4*>(src)[k];
    for (int k = 4 * n4 + t; k < n; k += kTile) dst[k] = src[k];
  } else {
    for (int k = t; k < n; k += kTile) dst[k] = src[k];
  }
}

// Stores the rows (width floats each) of a block's n pixels, staged in
// shared memory at src, as the rows (first + p) S + k of dst: with S = 1 one
// contiguous run (store_run), else one row of every S.
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float* src, int width, int n,
                                           long long first, int samples, int k, int t) {
  if (samples == 1) {
    store_run(dst + width * first, src, width * n, t);
    return;
  }
  for (int e = t; e < width * n; e += kTile) {
    const int p = e / width;
    dst[((first + p) * samples + k) * width + (e - p * width)] = src[e];
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// PyTorch's pow(tensor, scalar) on the card, for the exponents 2^x of the
// opacity warm-up: 1 is a copy, 0.5 a sqrt, 2 (of the exponent cast to
// float) a product, the rest powf.
__device__ float torch_pow(float base, double e) {
  if (e == 1.0) return base;
  if (e == 0.5) return sqrtf(base);
  const float ef = (float)e;
  return ef == 2.0f ? base * base : powf(base, ef);
}

// geometry/sh.py `_ivanic_next_degree`: entry (m, n) of the unsigned degree-l
// matrix from the degree-1 one `d1` ((i, j) at [i + 1][j + 1]) and the
// degree-(l - 1) one `dp` ((a, b) at [a + l - 1][b + l - 1]). The same
// products, sums and coefficients (double, then float32), and the same terms
// left out where a coefficient is 0.
struct Ivanic {
  const float* d1;
  const float* dp;
  int l;

  __device__ float r(int i, int j) const { return d1[(i + 1) * 3 + (j + 1)]; }
  __device__ float d(int a, int b) const { return dp[(a + l - 1) * (2 * l - 1) + (b + l - 1)]; }
  __device__ float P(int i, int a, int b) const {
    if (b == l) return r(i, 1) * d(a, l - 1) - r(i, -1) * d(a, -l + 1);
    if (b == -l) return r(i, 1) * d(a, -l + 1) + r(i, -1) * d(a, l - 1);
    return r(i, 0) * d(a, b);
  }
  __device__ float entry(int m, int n) const {
    const double denom = abs(n) < l ? (double)((l + n) * (l - n)) : (double)(2 * l * (2 * l - 1));
    const int am = abs(m);
    const double delta = m == 0 ? 1.0 : 0.0;
    const double u_c = sqrt((l + m) * (l - m) / denom);
    const double v_c = 0.5 * sqrt((1.0 + delta) * (l + am - 1) * (l + am) / denom) * (1.0 - 2.0 * delta);
    const double w_c = -0.5 * sqrt((l - am - 1) * (l - am) / denom) * (1.0 - delta);
    const float sqrt2 = (float)sqrt(2.0);
    float term = 0.0f;
    if (u_c != 0.0) term = term + (float)u_c * P(0, m, n);
    if (v_c != 0.0) {
      float v_val;
      if (m == 0) v_val = P(1, 1, n) + P(-1, -1, n);
      else if (m == 1) v_val = P(1, 0, n) * sqrt2;  // the P(-1, ...) term's factor is 0
      else if (m > 1) v_val = P(1, m - 1, n) - P(-1, -m + 1, n);
      else if (m == -1) v_val = P(-1, 0, n) * sqrt2;  // the P(1, ...) term's factor is 0
      else v_val = P(1, m + 1, n) + P(-1, -m - 1, n);
      term = term + (float)v_c * v_val;
    }
    if (w_c != 0.0) {
      const float w_val = m > 0 ? P(1, m + 1, n) + P(-1, -m - 1, n) : P(1, m - 1, n) - P(-1, -m + 1, n);
      term = term + (float)w_c * w_val;
    }
    return term;
  }
};

// The camera's K^-1, multiplier, C and origin into s_cam (one thread).
__device__ void camera_prologue(const Args& a, int cam, float* s_cam) {
  const float* k = a.intr + cam * 9;
  const float* e = a.extr + cam * 16;
  const double k0 = k[0], k1 = k[1], k2 = k[2], k3 = k[3], k4 = k[4], k5 = k[5], k6 = k[6], k7 = k[7], k8 = k[8];
  const double det = k0 * (k4 * k8 - k5 * k7) - k1 * (k3 * k8 - k5 * k6) + k2 * (k3 * k7 - k4 * k6);
  s_cam[0] = (float)((k4 * k8 - k5 * k7) / det);
  s_cam[1] = (float)((k2 * k7 - k1 * k8) / det);
  s_cam[2] = (float)((k1 * k5 - k2 * k4) / det);
  s_cam[3] = (float)((k5 * k6 - k3 * k8) / det);
  s_cam[4] = (float)((k0 * k8 - k2 * k6) / det);
  s_cam[5] = (float)((k2 * k3 - k0 * k5) / det);
  s_cam[6] = (float)((k3 * k7 - k4 * k6) / det);
  s_cam[7] = (float)((k1 * k6 - k0 * k7) / det);
  s_cam[8] = (float)((k0 * k4 - k1 * k3) / det);
  // 0.1 * sum(inv(K[:2, :2]) @ (1/W, 1/H)); the pixel size as the plain
  // version's float32 tensor of Python floats.
  const double det2 = k0 * k4 - k1 * k3;
  const float i00 = (float)(k4 / det2), i01 = (float)(-k1 / det2), i10 = (float)(-k3 / det2), i11 = (float)(k0 / det2);
  const float px = (float)(1.0 / a.w), py = (float)(1.0 / a.h);
  s_cam[21] = 0.1f * ((i00 * px + i01 * py) + (i10 * px + i11 * py));
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) s_cam[9 + 3 * i + j] = e[4 * i + j];
    s_cam[18 + i] = e[4 * i + 3];
  }
}

template <int kDeg, bool kSamples>
__global__ void __launch_bounds__(kTile) gaussian_adapter_kernel(const Args a) {
  constexpr int kDsh = (kDeg + 1) * (kDeg + 1);
  constexpr int kRow = 3 * kDsh;
  constexpr int kStage = kRow > kGeomFloats ? kRow : kGeomFloats;
  __shared__ float s_rot[d_offset(kDeg + 1) + 1];
  __shared__ float s_cam[kCamFloats];
  __shared__ __align__(16) float s_stage[kTile * kStage];

  const int t = threadIdx.x;
  const int cam = blockIdx.y;
  const int bi = cam / a.v, vi = cam - bi * a.v;
  const long long r = (long long)a.h * a.w;
  const long long p0 = (long long)blockIdx.x * kTile;
  const int n_live = (int)min((long long)kTile, r - p0);
  const bool live = t < n_live;
  const long long pix = p0 + (live ? t : 0);
  const float* raw = a.raw + bi * a.s_b + vi * a.s_v + pix * a.s_p;
  const int S = kSamples ? a.samples : 1;
  const long long gi = cam * r + pix;  // this pixel in the (b, v r) layouts; its Gaussians are gi S + k

  // This pixel's geometry inputs, issued before the prologue (the depth and
  // density of its first sample).
  float in[11];  // offset x, y; scale x, y, z; quaternion x, y, z, w; depth; density
  if (live) {
#pragma unroll
    for (int k = 0; k < 9; ++k) in[k] = raw[k * a.s_c];
    in[9] = a.depth[gi * S];
    in[10] = a.density[gi * S];
  }

  // ---- the camera's prologue --------------------------------------------------
  const float* extr = a.extr + cam * 16;
  // D_1: C in the degree-1 real SH basis' order (y, z, x), index i -> (i + 1) % 3.
  if (kDeg >= 1 && t < 9) s_rot[t] = extr[4 * ((t / 3 + 1) % 3) + (t % 3 + 1) % 3];
  if (t == 32) camera_prologue(a, cam, s_cam);
  __syncthreads();
#pragma unroll
  for (int l = 2; l <= kDeg; ++l) {
    const int side = 2 * l + 1;
    if (t < side * side) {
      const Ivanic iv{s_rot, s_rot + d_offset(l - 1), l};
      s_rot[d_offset(l) + t] = iv.entry(t / side - l, t % side - l);
    }
    __syncthreads();
  }
  // The graphics basis: D_l[m][n] times (-1)^|m| (-1)^|n|.
#pragma unroll
  for (int l = 1; l <= kDeg; ++l) {
    const int side = 2 * l + 1;
    for (int k = t; k < side * side; k += kTile) {
      if ((abs(k / side - l) + abs(k % side - l)) & 1) s_rot[d_offset(l) + k] = -s_rot[d_offset(l) + k];
    }
  }
  __syncthreads();

  // ---- geometry: means, covariance, opacity, scales, rotation, a sample at a time
  const long long g0 = cam * r + p0;  // the block's first pixel
  const float* kinv = s_cam;
  const float* c = s_cam + 9;
  const float* origin = s_cam + 18;
  float dir[3], rq[9], qi = 0.0f, qj = 0.0f, qk = 0.0f, qr = 0.0f;
  if (live) {
    // The ray coordinate: sample_image_grid's pixel centre (col + 0.5) / W, a
    // multiplication by 1 / W on the card, plus the offset.
    const int row = (int)(pix / a.w), col = (int)(pix - (long long)row * a.w);
    const float gx = ((float)col + 0.5f) * (1.0f / (float)a.w);
    const float gy = ((float)row + 0.5f) * (1.0f / (float)a.h);
    const float px = (float)(1.0 / a.w), py = (float)(1.0 / a.h);
    const float x = gx + (sigmoid(in[0]) - 0.5f) * px;
    const float y = gy + (sigmoid(in[1]) - 0.5f) * py;
    // The world ray's direction in the camera.
#pragma unroll
    for (int i = 0; i < 3; ++i) dir[i] = (kinv[3 * i] * x + kinv[3 * i + 1] * y) + kinv[3 * i + 2];
    const float norm = sqrtf((dir[0] * dir[0] + dir[1] * dir[1]) + dir[2] * dir[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) dir[i] = dir[i] / norm;
    // The rotation: q / (|q| + eps), then quaternion_to_matrix (eps again).
    const float qn = sqrtf(((in[5] * in[5] + in[6] * in[6]) + in[7] * in[7]) + in[8] * in[8]) + 1e-8f;
    qi = in[5] / qn, qj = in[6] / qn, qk = in[7] / qn, qr = in[8] / qn;
    const float two_s = (1.0f / ((((qi * qi + qj * qj) + qk * qk) + qr * qr) + 1e-8f)) * 2.0f;
    rq[0] = 1.0f - two_s * (qj * qj + qk * qk), rq[1] = two_s * (qi * qj - qk * qr), rq[2] = two_s * (qi * qk + qj * qr);
    rq[3] = two_s * (qi * qj + qk * qr), rq[4] = 1.0f - two_s * (qi * qi + qk * qk), rq[5] = two_s * (qj * qk - qi * qr);
    rq[6] = two_s * (qi * qk - qj * qr), rq[7] = two_s * (qj * qk + qi * qr), rq[8] = 1.0f - two_s * (qi * qi + qj * qj);
  }
  for (int k = 0; k < S; ++k) {
    if (live) {
      const float depth = k == 0 ? in[9] : a.depth[gi * S + k];
      const float pdf = k == 0 ? in[10] : a.density[gi * S + k];
      // The mean.
      float* st_mean = s_stage + 3 * t;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float world = (c[3 * i] * dir[0] + c[3 * i + 1] * dir[1]) + c[3 * i + 2] * dir[2];
        st_mean[i] = origin[i] + world * depth;
      }
      // The opacity.
      const float opacity = 0.5f * ((1.0f - torch_pow(1.0f - pdf, a.exponent)) + torch_pow(pdf, a.inv_exponent));
      a.opac[gi * S + k] = opacity * (1.0f / (float)a.gaussians_per_pixel);
      // The scales.
      float s[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) s[i] = ((a.scale_min + a.scale_range * sigmoid(in[2 + i])) * depth) * s_cam[21];
      // R diag(s^2) R^T, then C (.) C^T.
      float loc[9], m1[9];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          loc[3 * i + j] = ((rq[3 * i] * (s[0] * s[0])) * rq[3 * j] + (rq[3 * i + 1] * (s[1] * s[1])) * rq[3 * j + 1]) +
                           (rq[3 * i + 2] * (s[2] * s[2])) * rq[3 * j + 2];
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) m1[3 * i + j] = (c[3 * i] * loc[j] + c[3 * i + 1] * loc[3 + j]) + c[3 * i + 2] * loc[6 + j];
      }
      float* st_cov = s_stage + 3 * kTile + 9 * t;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) st_cov[3 * i + j] = (m1[3 * i] * c[3 * j] + m1[3 * i + 1] * c[3 * j + 1]) + m1[3 * i + 2] * c[3 * j + 2];
      }
      float* st_scale = s_stage + 12 * kTile + 3 * t;
      float* st_rot = s_stage + 15 * kTile + 4 * t;
#pragma unroll
      for (int i = 0; i < 3; ++i) st_scale[i] = s[i];
      st_rot[0] = qi;
      st_rot[1] = qj;
      st_rot[2] = qk;
      st_rot[3] = qr;
    }
    __syncthreads();
    store_rows(a.means, s_stage, 3, n_live, g0, S, k, t);
    store_rows(a.cov, s_stage + 3 * kTile, 9, n_live, g0, S, k, t);
    if (a.scales != nullptr) {
      store_rows(a.scales, s_stage + 12 * kTile, 3, n_live, g0, S, k, t);
      store_rows(a.rots, s_stage + 15 * kTile, 4, n_live, g0, S, k, t);
    }
    __syncthreads();
  }

  // ---- SH: damp, then rotate each degree's block ------------------------------
  if (live) {
    const float* sh = raw + 9 * a.s_c;
    float* st = s_stage + kRow * t;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      st[ch * kDsh] = sh[(ch * kDsh) * a.s_c];  // degree 0: damping 1, D_0 = 1
#pragma unroll
      for (int l = 1; l <= kDeg; ++l) {
        const int side = 2 * l + 1;
        const float damping = sh_damping(l);
        float x[2 * kDeg + 1];
#pragma unroll
        for (int n = 0; n < side; ++n) x[n] = sh[(ch * kDsh + l * l + n) * a.s_c] * damping;
        const float* d = s_rot + d_offset(l);
#pragma unroll
        for (int m = 0; m < side; ++m) {
          float acc = d[m * side] * x[0];
#pragma unroll
          for (int n = 1; n < side; ++n) acc = acc + d[m * side + n] * x[n];
          st[ch * kDsh + l * l + m] = acc;
        }
      }
    }
  }
  __syncthreads();
  for (int k = 0; k < S; ++k) store_rows(a.harm, s_stage, kRow, n_live, g0, S, k, t);
}

template <int kDeg>
cudaError_t launch(const Args& a, unsigned tiles, unsigned cams, cudaStream_t s) {
  if (a.samples == 1) {
    gaussian_adapter_kernel<kDeg, false><<<dim3(tiles, cams), kTile, 0, s>>>(a);
  } else {
    gaussian_adapter_kernel<kDeg, true><<<dim3(tiles, cams), kTile, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// raw (b, v, H W, >= 9 + 3 d_sh) at element strides (s_b, s_v, s_p, s_c);
// depth, density (b, v, H W, samples); intr (b, v, 3, 3); extr (b, v, 4, 4);
// all float32, the last four contiguous. Outputs as listed above, contiguous;
// scales and rots both null or both given.
extern "C" int tp_gaussian_adapter(const float* raw, const float* depth, const float* density, const float* intr,
                                   const float* extr, float* means, float* cov, float* harm, float* opac,
                                   float* scales, float* rots, int b, int v, int h, int w, int degree,
                                   long long s_b, long long s_v, long long s_p, long long s_c, float scale_min,
                                   float scale_range, double exponent, double inv_exponent,
                                   int gaussians_per_pixel, int samples, void* stream) {
  const long long r = (long long)h * w;
  if (r == 0 || b == 0 || v == 0) return 0;
  if (degree < 0 || degree > 4 || (long long)b * v > 65535 || samples < 1) return (int)cudaErrorInvalidValue;
  const Args a{raw, depth, density, intr, extr, means, cov, harm, opac, scales, rots, v, h, w,
               s_b, s_v, s_p, s_c, scale_min, scale_range, exponent, inv_exponent, gaussians_per_pixel, samples};
  const unsigned tiles = (unsigned)((r + kTile - 1) / kTile), cams = (unsigned)(b * v);
  cudaStream_t s = (cudaStream_t)stream;
  switch (degree) {
    case 0: return (int)launch<0>(a, tiles, cams, s);
    case 1: return (int)launch<1>(a, tiles, cams, s);
    case 2: return (int)launch<2>(a, tiles, cams, s);
    case 3: return (int)launch<3>(a, tiles, cams, s);
    default: return (int)launch<4>(a, tiles, cams, s);
  }
}
