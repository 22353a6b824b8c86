"""Per-Gaussian screen-space preparation for the tile rasterizer.

Counterpart of transplat_tpu/ops/rasterizer/projection.py, batched over
views instead of vmapped. The EWA-splatting conventions are kept exactly:

  * camera-space cull at z <= 0.2
  * perspective Jacobian with tan-fov clamping at 1.3x the frustum
  * +0.3 screen-space low-pass on the 2D covariance diagonal
  * radius = ceil(3 * sqrt(max eigenvalue of 2D covariance))
  * color = max(SH(view direction) + 0.5, 0)
  * integer pixel centres and a circular radius cutoff (gaussian_alpha)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...geometry.sh import eval_sh


ALPHA_MIN = 1.0 / 255.0  # below it a Gaussian does not touch the pixel
ALPHA_MAX = 0.99  # cap of a single Gaussian's alpha


class ProjectedGaussians(NamedTuple):
    """Screen-space Gaussian data, (B, G, ...) for B views."""

    mean2d: torch.Tensor  # (B, G, 2) pixel coordinates
    depth: torch.Tensor  # (B, G) camera-space z
    conic: torch.Tensor  # (B, G, 3) inverse 2D covariance (a, b, c) of [[a,b],[b,c]]
    radius: torch.Tensor  # (B, G) screen-space radius in pixels (0 for culled)
    rgb: torch.Tensor  # (B, G, 3) view-dependent color (SH evaluated)
    opacity: torch.Tensor  # (B, G)
    valid: torch.Tensor  # (B, G) bool

    def view(self, i: int) -> "ProjectedGaussians":
        """The (G, ...) slice of view i."""
        return ProjectedGaussians(*(f[i] for f in self))


def project_gaussians(
    means: torch.Tensor,  # (B, G, 3) world positions
    covariances: torch.Tensor,  # (B, G, 3, 3)
    sh: torch.Tensor,  # (B, G, 3, n_sh)
    opacities: torch.Tensor,  # (B, G)
    extrinsics: torch.Tensor,  # (B, 4, 4) camera-to-world
    tan_fovx: torch.Tensor,  # (B,)
    tan_fovy: torch.Tensor,  # (B,)
    image_shape: tuple[int, int],
    near_cull: float = 0.2,
    eps: float = 1e-6,
) -> ProjectedGaussians:
    """Project world-space Gaussians into B cameras (symmetric frustum:
    focal length from the field of view, principal point at the image centre)."""
    h, w = image_shape
    w2c = torch.linalg.inv(extrinsics)
    rot = w2c[:, :3, :3]
    trans = w2c[:, :3, 3]

    t = torch.matmul(means, rot.transpose(-1, -2)) + trans[:, None, :]  # (B, G, 3)
    depth = t[..., 2]
    valid = depth > near_cull

    fx = ((0.5 * w) / tan_fovx)[:, None]
    fy = ((0.5 * h) / tan_fovy)[:, None]
    cx = (w - 1.0) / 2.0
    cy = (h - 1.0) / 2.0

    z = torch.where(valid, depth, torch.ones_like(depth))
    mean2d = torch.stack([fx * t[..., 0] / z + cx, fy * t[..., 1] / z + cy], dim=-1)

    # EWA: 2D covariance = J W Sigma W^T J^T with a frustum-clamped Jacobian.
    limx = (1.3 * tan_fovx)[:, None]
    limy = (1.3 * tan_fovy)[:, None]
    txtz = torch.clamp(t[..., 0] / z, -limx, limx)
    tytz = torch.clamp(t[..., 1] / z, -limy, limy)
    tx = txtz * z
    ty = tytz * z

    # Rows of J W: u = (fx/z) r0 - (fx tx/z^2) r2, v = (fy/z) r1 - (fy ty/z^2) r2.
    pu = fx / z
    qu = -fx * tx / (z * z)
    pv = fy / z
    qv = -fy * ty / (z * z)
    u = [pu * rot[:, 0, k, None] + qu * rot[:, 2, k, None] for k in range(3)]
    v = [pv * rot[:, 1, k, None] + qv * rot[:, 2, k, None] for k in range(3)]
    s = [[covariances[..., k, l] for l in range(3)] for k in range(3)]

    def quad(x, y):  # x^T Sigma y, Sigma symmetric
        return sum(x[k] * sum(s[k][l] * y[l] for l in range(3)) for k in range(3))

    a = quad(u, u) + 0.3
    b = quad(u, v)
    c = quad(v, v) + 0.3

    det = a * c - b * b
    valid = valid & (det > 0.0)
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))
    radius = torch.where(valid, radius, torch.zeros_like(radius))

    campos = extrinsics[:, None, :3, 3]
    dirs = means - campos
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=eps)
    rgb = torch.clamp(eval_sh(sh, dirs) + 0.5, min=0.0)

    return ProjectedGaussians(
        mean2d=mean2d, depth=depth, conic=conic, radius=radius, rgb=rgb,
        opacity=opacities, valid=valid,
    )


def gaussian_alpha(
    conic: torch.Tensor,
    mean2d: torch.Tensor,
    opacity: torch.Tensor,
    pixel_xy: torch.Tensor,
    radius: torch.Tensor | None = None,
    alpha_min: float = ALPHA_MIN,
    alpha_max: float = ALPHA_MAX,
) -> torch.Tensor:
    """Alpha of Gaussians at pixels (broadcasting): clamped at 0.99, zeroed
    below 1/255, for power > 0, and outside the circular radius cutoff."""
    dx = pixel_xy[..., 0] - mean2d[..., 0]
    dy = pixel_xy[..., 1] - mean2d[..., 1]
    power = -0.5 * (conic[..., 0] * dx * dx + conic[..., 2] * dy * dy) - conic[..., 1] * dx * dy
    alpha = torch.clamp(opacity * torch.exp(power), max=alpha_max)
    keep = (power <= 0.0) & (alpha >= alpha_min)
    if radius is not None:
        keep = keep & (dx * dx + dy * dy <= radius * radius)
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def pixel_centers(image_shape: tuple[int, int], device=None, dtype=torch.float32) -> torch.Tensor:
    """Integer pixel-centre coordinates (h, w, 2) in pixel units (x = col, y = row)."""
    h, w = image_shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys], dim=-1)
