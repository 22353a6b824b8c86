// The render's projection, forward, as one kernel.
//
// Replaces no TPU kernel. The JAX package leaves the projection
// (transplat_tpu/ops/rasterizer/projection.py, with get_fov and the depth
// sort's row packing) to XLA, which fuses it. Run eagerly, its plain PyTorch
// version (ops/rasterizer/projection.py `project_rows_plain`: project_views,
// project_gaussians, eval_sh, pack_rows) dispatches ~300 ops a render, two
// torch.linalg.inv calls that read their error codes back to the host and
// four constants copied from it. Its cost was host time, not device time.
//
// Computes, for every Gaussian g of set s and every camera c of the `views`
// cameras that see set s (camera index s * views + j), what the plain version
// computes, in float32 and in its order of operations:
//   * per camera (a prologue in shared memory): with scale_invariant the
//     scale 1 / near (else 1); the scaled camera-to-world matrix's inverse in
//     double (by cofactors, no torch.linalg.inv), rounded to float32; the
//     camera position; tan(fov / 2) from the rays of K^-1 (K^-1 in double by
//     its adjugate), in float32 as get_fov takes it (normalised rays, acos of
//     their dot product), off-centre intrinsics included; fx, fy and the
//     frustum clamp 1.3 tan(fov / 2);
//   * per Gaussian: the scaled mean in the camera, the z <= 0.2 cull, the
//     frustum-clamped Jacobian, the 2D covariance + 0.3, the conic and the
//     det > 0 test, the radius ceil(3 sqrt(lambda_max)), and SH degree 0-4 at
//     the unit direction from the camera, max(. + 0.5, 0).
// It writes, in the depth sort's semantics (ops/rasterizer/projection.py
// `pack_rows`):
//   * keys (B, G): the depth of a live Gaussian (valid, radius > 0), +inf
//     for the rest;
//   * rows (B, G, 8): the unsorted geometry rows of binning.py's columns, a
//     dead row with its mean at 1e9 and radius and opacity 0, its conic kept;
//   * colors (B, G, 3), unless the caller composites a feature of its own;
//   * radii (B, G): the radius where valid, else 0 (RenderOutput.radii).
// The stable sort of the keys and the gathers stay with the caller.
//
// What bounds it on an H100: device-memory bytes. A Gaussian reads 88 floats
// at SH degree 4 (mean 3, covariance 9, SH 75, opacity 1) once for all its
// cameras and writes 13 a camera: 53 MB at 131,072 Gaussians and one camera,
// 16 us at 3.35 TB/s. Its ~400 flops a Gaussian and camera are ~1 us.
//
// Design: a block of kTile threads takes kTile consecutive Gaussians of one
// set (grid: Gaussian tiles x sets), one Gaussian a thread, and loops over the
// set's cameras, so a Gaussian is read from device memory once a set, not
// once a view.
//   * Reads: a Gaussian's rows (12 B of mean, 36 B of covariance, 300 B of SH
//     at degree 4) are not 16-byte aligned one by one, so one thread a row
//     would touch 32 lines a warp load. The block stages its slabs (the
//     block's rows are contiguous) through shared memory, consecutive threads
//     on consecutive float4s where the slab starts 16-byte aligned, else
//     floats, and each thread reads its row there (a row stride of 75 or 9
//     floats is odd: a warp hits 32 banks).
//   * The camera prologue is computed in shared memory, kCams cameras at a
//     time, after the slabs' loads are issued, so the two overlap. Done by one
//     thread a camera it was ~5 us of serial double divisions, square roots,
//     acos and tan that every block waited for (H100, 700 W: 0.044 ms cold at
//     131,072 Gaussians; the same prologue in a kernel of its own: 0.032;
//     spread as below, in this one launch: 0.031). So it is
//     spread: 12 threads a camera each take one entry of the inverse (its
//     cofactor, the determinant, one division), and 2 threads a camera on
//     another warp take the two fields of view.
//   * Registers: capped for 4 blocks an SM (shared memory allows 4 at SH 4);
//     uncapped, 141 registers gave 3 (on the H100: 0.037 against 0.044 ms
//     cold, with the prologue one thread a camera).
//   * Writes: a key, a radius, two float4s of row and three colours a
//     Gaussian and camera; consecutive threads write consecutive rows.
//   * Rounding: built with -fmad=false, like every kernel here, so no product
//     and sum contract. Where the plain version multiplies small matrices
//     through cuBLAS (the mean into the camera, K^-1's rays), the kernel
//     accumulates with explicit fused multiply-adds in the order of the inner
//     index. Elsewhere the same float32 operations in the same order, so that
//     on cameras whose inverse and rays round alike the rows come out bit for
//     bit (the card tests hold them to the plain chain).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kCams = 32;  // cameras whose values a block holds at a time
// A camera's values in shared memory: w2c rotation, translation, position,
// fx, fy, the frustum clamps, the scale and its square.
constexpr int kRot = 0, kTrans = 9, kPos = 12, kFx = 15, kFy = 16, kLimX = 17, kLimY = 18, kScale = 19,
              kCovScale = 20, kCamFloats = 21;

struct Args {
  const float* extr;
  const float* intr;
  const float* near;
  const float* means;
  const float* cov;
  const float* sh;
  const float* opac;
  float* keys;
  float* rows;
  float* colors;  // or null
  float* radii;
  long long g;
  int views;
  int h, w;
  bool scale_invariant;
};

// geometry/sh.py's constants, as PyTorch takes a Python float: rounded to
// double, then to float32.
constexpr float kC0 = (float)0.28209479177387814;
constexpr float kC1 = (float)0.4886025119029199;
constexpr float kC2_0 = (float)1.0925484305920792;
constexpr float kC2_1 = (float)-1.0925484305920792;
constexpr float kC2_2 = (float)0.31539156525252005;
constexpr float kC2_3 = (float)-1.0925484305920792;
constexpr float kC2_4 = (float)0.5462742152960396;
constexpr float kC3_0 = (float)-0.5900435899266435;
constexpr float kC3_1 = (float)2.890611442640554;
constexpr float kC3_2 = (float)-0.4570457994644658;
constexpr float kC3_3 = (float)0.3731763325901154;
constexpr float kC3_4 = (float)-0.4570457994644658;
constexpr float kC3_5 = (float)1.445305721320277;
constexpr float kC3_6 = (float)-0.5900435899266435;
constexpr float kC4_0 = (float)2.5033429417967046;
constexpr float kC4_1 = (float)-1.7701307697799304;
constexpr float kC4_2 = (float)0.9461746957575601;
constexpr float kC4_3 = (float)-0.6690465435572892;
constexpr float kC4_4 = (float)0.10578554691520431;
constexpr float kC4_5 = (float)-0.6690465435572892;
constexpr float kC4_6 = (float)0.47308734787878004;
constexpr float kC4_7 = (float)-1.7701307697799304;
constexpr float kC4_8 = (float)0.6258357354491761;

// torch.clamp's NaN rule: a NaN input stays NaN.
__device__ __forceinline__ float clamp(float v, float lo, float hi) { return isnan(v) ? v : fminf(fmaxf(v, lo), hi); }
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }

// Copies n floats of global memory at src into shared memory at dst (16-byte
// aligned), consecutive threads on consecutive float4s where src is aligned.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n, int t) {
  if (((uintptr_t)src & 15) == 0) {
    const int n4 = n >> 2;
    for (int k = t; k < n4; k += kTile) reinterpret_cast<float4*>(dst)[k] = __ldg(reinterpret_cast<const float4*>(src) + k);
    for (int k = 4 * n4 + t; k < n; k += kTile) dst[k] = __ldg(src + k);
  } else {
    for (int k = t; k < n; k += kTile) dst[k] = __ldg(src + k);
  }
}

// Cofactor (i, j) of a 4x4 matrix (row-major), in double.
__device__ double cofactor(const double* m, int i, int j) {
  int r[3], c[3];
  for (int k = 0, n = 0; k < 4; ++k)
    if (k != i) r[n++] = 4 * k;
  for (int k = 0, n = 0; k < 4; ++k)
    if (k != j) c[n++] = k;
  const double d = m[r[0] + c[0]] * (m[r[1] + c[1]] * m[r[2] + c[2]] - m[r[1] + c[2]] * m[r[2] + c[1]]) -
                   m[r[0] + c[1]] * (m[r[1] + c[0]] * m[r[2] + c[2]] - m[r[1] + c[2]] * m[r[2] + c[0]]) +
                   m[r[0] + c[2]] * (m[r[1] + c[0]] * m[r[2] + c[1]] - m[r[1] + c[1]] * m[r[2] + c[0]]);
  return ((i + j) & 1) ? -d : d;
}

// project_views' scale: 1 / near (a reciprocal, then * 1.0), or 1.
__device__ __forceinline__ float camera_scale(const Args& a, long long cam) {
  return a.scale_invariant ? 1.0f / a.near[cam] : 1.0f;
}

// Entry e (row e / 4 < 3, column e % 4) of the inverse of camera cam's
// scaled camera-to-world matrix, by cofactors in double, into c; with the
// translation's column also the camera position.
__device__ void camera_inverse_entry(const Args& a, long long cam, int e, float* c) {
  const float* src = a.extr + 16 * cam;
  const float scale = camera_scale(a, cam);
  double m[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = (i & 3) == 3 && i < 12 ? (double)(src[i] * scale) : (double)src[i];
  const double det = m[0] * cofactor(m, 0, 0) + m[1] * cofactor(m, 0, 1) + m[2] * cofactor(m, 0, 2) + m[3] * cofactor(m, 0, 3);
  const int r = e >> 2, j = e & 3;
  const float v = (float)(cofactor(m, j, r) / det);  // the inverse is the adjugate (cofactors transposed) over det
  if (j < 3) {
    c[kRot + 3 * r + j] = v;
  } else {
    c[kTrans + r] = v;
    c[kPos + r] = src[4 * r + 3] * scale;
  }
}

// get_fov's ray: K^-1 (x, y, 1), normalised, in float32.
__device__ void fov_ray(const float* kinv, float x, float y, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = fmaf(kinv[3 * i + 2], 1.0f, fmaf(kinv[3 * i + 1], y, kinv[3 * i] * x));
  const float norm = sqrtf(fmaf(out[2], out[2], fmaf(out[1], out[1], out[0] * out[0])));
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = out[i] / norm;
}

// Camera cam's field of view along `axis` (0: x, 1: y) into c: get_fov's
// angle between the rays through the image's two edge midpoints (K^-1 by its
// adjugate in double), then fx or fy = (0.5 w) / tan, a reciprocal and then a
// product as project_gaussians takes it, and the frustum clamp 1.3 tan;
// axis 0 also writes the scale and its square.
__device__ void camera_fov(const Args& a, long long cam, int axis, float* c) {
  const float* k = a.intr + 9 * cam;
  const double k0 = k[0], k1 = k[1], k2 = k[2], k3 = k[3], k4 = k[4], k5 = k[5], k6 = k[6], k7 = k[7], k8 = k[8];
  const double det = k0 * (k4 * k8 - k5 * k7) - k1 * (k3 * k8 - k5 * k6) + k2 * (k3 * k7 - k4 * k6);
  const float kinv[9] = {(float)((k4 * k8 - k5 * k7) / det), (float)((k2 * k7 - k1 * k8) / det),
                         (float)((k1 * k5 - k2 * k4) / det), (float)((k5 * k6 - k3 * k8) / det),
                         (float)((k0 * k8 - k2 * k6) / det), (float)((k2 * k3 - k0 * k5) / det),
                         (float)((k3 * k7 - k4 * k6) / det), (float)((k1 * k6 - k0 * k7) / det),
                         (float)((k0 * k4 - k1 * k3) / det)};
  float p[3], q[3];
  fov_ray(kinv, axis ? 0.5f : 0.0f, axis ? 0.0f : 0.5f, p);
  fov_ray(kinv, axis ? 0.5f : 1.0f, axis ? 1.0f : 0.5f, q);
  const float tan_half = tanf(0.5f * acosf((p[0] * q[0] + p[1] * q[1]) + p[2] * q[2]));
  c[kFx + axis] = (1.0f / tan_half) * (float)(0.5 * (axis ? a.h : a.w));
  c[kLimX + axis] = 1.3f * tan_half;
  if (axis == 0) {
    const float scale = camera_scale(a, cam);
    c[kScale] = scale;
    c[kCovScale] = scale * scale;
  }
}

// geometry/sh.py's basis at degrees 0..kDeg into out[(kDeg + 1)^2].
template <int kDeg>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* out) {
  out[0] = kC0;
  if (kDeg < 1) return;
  out[1] = -kC1 * y;
  out[2] = kC1 * z;
  out[3] = -kC1 * x;
  if (kDeg < 2) return;
  const float xx = x * x, yy = y * y, zz = z * z;
  out[4] = kC2_0 * x * y;
  out[5] = kC2_1 * y * z;
  out[6] = kC2_2 * (2.0f * zz - xx - yy);
  out[7] = kC2_3 * x * z;
  out[8] = kC2_4 * (xx - yy);
  if (kDeg < 3) return;
  out[9] = kC3_0 * y * (3.0f * xx - yy);
  out[10] = kC3_1 * x * y * z;
  out[11] = kC3_2 * y * (4.0f * zz - xx - yy);
  out[12] = kC3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  out[13] = kC3_4 * x * (4.0f * zz - xx - yy);
  out[14] = kC3_5 * z * (xx - yy);
  out[15] = kC3_6 * x * (xx - 3.0f * yy);
  if (kDeg < 4) return;
  out[16] = kC4_0 * x * y * (xx - yy);
  out[17] = kC4_1 * y * z * (3.0f * xx - yy);
  out[18] = kC4_2 * x * y * (7.0f * zz - 1.0f);
  out[19] = kC4_3 * y * z * (7.0f * zz - 3.0f);
  out[20] = kC4_4 * (zz * (35.0f * zz - 30.0f) + 3.0f);
  out[21] = kC4_5 * x * z * (7.0f * zz - 3.0f);
  out[22] = kC4_6 * (xx - yy) * (7.0f * zz - 1.0f);
  out[23] = kC4_7 * x * z * (xx - 3.0f * yy);
  out[24] = kC4_8 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
}

// kDeg -1: no colours (the caller composites a feature of its own).
template <int kDeg>
__global__ void __launch_bounds__(kTile, 4) project_kernel(const Args a) {
  constexpr int kDsh = kDeg < 0 ? 0 : (kDeg + 1) * (kDeg + 1);
  constexpr int kRow = 3 * kDsh;
  __shared__ __align__(16) float s_geo[kTile * 12];  // the block's means (3 a row), then covariances (9)
  __shared__ __align__(16) float s_sh[kRow > 0 ? kTile * kRow : 4];
  __shared__ float s_cam[kCams * kCamFloats];

  const int t = threadIdx.x, set = blockIdx.y;
  const long long i0 = (long long)blockIdx.x * kTile;
  const int n = (int)min((long long)kTile, a.g - i0);
  const long long first = set * a.g + i0;  // the block's first Gaussian in the (b, G) inputs
  stage(s_geo, a.means + 3 * first, 3 * n, t);
  stage(s_geo + 3 * kTile, a.cov + 9 * first, 9 * n, t);
  if (kRow > 0) stage(s_sh, a.sh + kRow * first, kRow * n, t);
  const bool mine = t < n;
  const float opacity = mine ? __ldg(a.opac + first + t) : 0.0f;

  for (int c0 = 0; c0 < a.views; c0 += kCams) {
    const int nc = min(kCams, a.views - c0);
    // The cameras' values: 12 threads a camera for the inverse's entries
    // from the block's first warp on, 2 for the fields of view from its last
    // thread down, so that the two run on different warps.
    const long long cam0 = (long long)set * a.views + c0;
    for (int k = t; k < 12 * nc; k += kTile) camera_inverse_entry(a, cam0 + k / 12, k % 12, s_cam + (k / 12) * kCamFloats);
    for (int k = kTile - 1 - t; k < 2 * nc; k += kTile) camera_fov(a, cam0 + k / 2, k % 2, s_cam + (k / 2) * kCamFloats);
    __syncthreads();
    if (mine) {
      const float* gm = s_geo + 3 * t;
      const float* gc = s_geo + 3 * kTile + 9 * t;
      for (int j = 0; j < nc; ++j) {
        const float* c = s_cam + j * kCamFloats;
        const float* rot = c + kRot;
        const long long o = ((long long)set * a.views + c0 + j) * a.g + i0 + t;
        // The mean into the camera: means * scale, then means @ R^T + T.
        float m[3], p[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) m[k] = gm[k] * c[kScale];
#pragma unroll
        for (int k = 0; k < 3; ++k) p[k] = fmaf(m[2], rot[3 * k + 2], fmaf(m[1], rot[3 * k + 1], m[0] * rot[3 * k])) + c[kTrans + k];
        const float depth = p[2];
        bool valid = depth > 0.2f;
        const float z = valid ? depth : 1.0f;
        const float fx = c[kFx], fy = c[kFy];
        const float mx = (fx * p[0]) / z + (float)((a.w - 1.0) / 2.0);
        const float my = (fy * p[1]) / z + (float)((a.h - 1.0) / 2.0);
        // EWA: J W Sigma W^T J^T with the frustum-clamped Jacobian.
        const float tx = clamp(p[0] / z, -c[kLimX], c[kLimX]) * z;
        const float ty = clamp(p[1] / z, -c[kLimY], c[kLimY]) * z;
        const float pu = fx / z, qu = ((-fx) * tx) / (z * z);
        const float pv = fy / z, qv = ((-fy) * ty) / (z * z);
        float u[3], v[3], s[9];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          u[k] = pu * rot[k] + qu * rot[6 + k];
          v[k] = pv * rot[3 + k] + qv * rot[6 + k];
        }
#pragma unroll
        for (int k = 0; k < 9; ++k) s[k] = gc[k] * c[kCovScale];
        float su[3], sv[3];  // Sigma u, Sigma v
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          su[k] = (s[3 * k] * u[0] + s[3 * k + 1] * u[1]) + s[3 * k + 2] * u[2];
          sv[k] = (s[3 * k] * v[0] + s[3 * k + 1] * v[1]) + s[3 * k + 2] * v[2];
        }
        const float ca = ((u[0] * su[0] + u[1] * su[1]) + u[2] * su[2]) + 0.3f;
        const float cb = (u[0] * sv[0] + u[1] * sv[1]) + u[2] * sv[2];
        const float cc = ((v[0] * sv[0] + v[1] * sv[1]) + v[2] * sv[2]) + 0.3f;
        const float det = ca * cc - cb * cb;
        valid = valid && det > 0.0f;
        const float det_safe = det > 0.0f ? det : 1.0f;
        const float mid = 0.5f * (ca + cc);
        const float lambda1 = mid + sqrtf(clamp_min(mid * mid - det, 0.1f));
        const float radius = valid ? ceilf(3.0f * sqrtf(lambda1)) : 0.0f;
        const bool live = valid && radius > 0.0f;
        a.keys[o] = live ? depth : INFINITY;
        a.radii[o] = radius;
        float4* row = reinterpret_cast<float4*>(a.rows + 8 * o);
        row[0] = make_float4(live ? mx : 1e9f, live ? my : 1e9f, cc / det_safe, (-cb) / det_safe);
        row[1] = make_float4(ca / det_safe, live ? radius : 0.0f, live ? opacity : 0.0f, 0.0f);
        if (kDsh > 0) {
          // SH at the unit direction from the camera, + 0.5, clamped at 0.
          float d[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) d[k] = m[k] - c[kPos + k];
          const float norm = clamp_min(sqrtf(fmaf(d[2], d[2], fmaf(d[1], d[1], d[0] * d[0]))), 1e-6f);
          float basis[kDsh > 0 ? kDsh : 1];
          sh_basis<kDeg>(d[0] / norm, d[1] / norm, d[2] / norm, basis);
          const float* sh = s_sh + kRow * t;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            float acc = sh[ch * kDsh] * basis[0];
#pragma unroll
            for (int q = 1; q < kDsh; ++q) acc = fmaf(sh[ch * kDsh + q], basis[q], acc);
            a.colors[3 * o + ch] = clamp_min(acc + 0.5f, 0.0f);
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int kDeg>
cudaError_t launch(const Args& a, unsigned tiles, unsigned sets, cudaStream_t s) {
  project_kernel<kDeg><<<dim3(tiles, sets), kTile, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// extr (B, 4, 4), intr (B, 3, 3), near (B,) for B = sets * views cameras;
// means (sets, G, 3), cov (sets, G, 3, 3), sh (sets, G, 3, (degree + 1)^2),
// opac (sets, G); all float32 and contiguous. Outputs contiguous float32:
// keys (B, G), rows (B, G, 8), colors (B, G, 3) or null (then sh is not
// read), radii (B, G).
extern "C" int tp_project_gaussians(const float* extr, const float* intr, const float* near, const float* means,
                                    const float* cov, const float* sh, const float* opac, float* keys, float* rows,
                                    float* colors, float* radii, int sets, int views, long long g, int degree, int h,
                                    int w, int scale_invariant, void* stream) {
  if (g == 0 || sets == 0 || views == 0) return 0;
  if (degree < 0 || degree > 4 || sets > 65535 || views < 0 || g < 0) return (int)cudaErrorInvalidValue;
  const Args a{extr, intr, near, means, cov, sh, opac, keys, rows, colors, radii, g, views, h, w, scale_invariant != 0};
  const unsigned tiles = (unsigned)((g + kTile - 1) / kTile);
  cudaStream_t s = (cudaStream_t)stream;
  if (colors == nullptr) return (int)launch<-1>(a, tiles, (unsigned)sets, s);
  switch (degree) {
    case 0: return (int)launch<0>(a, tiles, (unsigned)sets, s);
    case 1: return (int)launch<1>(a, tiles, (unsigned)sets, s);
    case 2: return (int)launch<2>(a, tiles, (unsigned)sets, s);
    case 3: return (int)launch<3>(a, tiles, (unsigned)sets, s);
    default: return (int)launch<4>(a, tiles, (unsigned)sets, s);
  }
}
