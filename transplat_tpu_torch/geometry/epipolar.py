"""Plane-sweep / epipolar sampling geometry.

Counterpart of transplat_tpu/geometry/epipolar.py. Conventions:
  * pixel grid uses integer pixel coordinates 0..W-1 (no half-pixel shift)
  * returned sample locations are in [0, 1], normalized by (W-1, H-1)

The ray-segment functions (`project_rays`, `triangulate_depth`,
`depth_to_relative_disparity`) serve pixelSplat's epipolar sampler
(model/encoder_epipolar.py) and take projection.py's conventions instead:
camera-to-world extrinsics, normalized intrinsics, image coordinates in
[0, 1] with pixel centres at (x + 0.5) / W.
"""

from __future__ import annotations

import torch

from .projection import get_world_rays, homogenize_points, homogenize_vectors, transform_rigid


def relative_pose(extrinsics_ref: torch.Tensor, extrinsics_tgt: torch.Tensor) -> torch.Tensor:
    """Transform taking ref-camera points into tgt-camera coordinates. (`inv_ex`
    is `inv`'s kernel without its error check, which waits for the card.)"""
    return torch.matmul(torch.linalg.inv_ex(extrinsics_tgt).inverse, extrinsics_ref)


def pixel_grid(h: int, w: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Homogeneous integer pixel coordinates, shape (3, h*w): rows (x, y, 1)."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    ones = torch.ones_like(xs)
    return torch.stack([xs.reshape(-1), ys.reshape(-1), ones.reshape(-1)], dim=0)


def epipolar_sample_grid(
    intrinsics_px: torch.Tensor,
    rel_pose: torch.Tensor,
    depths: torch.Tensor,
    h: int,
    w: int,
    clamp_min_depth: float = 1e-3,
) -> torch.Tensor:
    """Project each ref pixel at D depth candidates into the other view.

    intrinsics_px (..., 3, 3), rel_pose (..., 4, 4), depths (..., D).
    Returns loc01 (..., D, h*w, 2) in [0, 1] (x, y), normalized by (w-1, h-1).
    """
    grid = pixel_grid(h, w, depths.device, depths.dtype)  # (3, HW)
    rays = torch.matmul(torch.linalg.inv_ex(intrinsics_px).inverse, grid)
    rays = torch.matmul(rel_pose[..., :3, :3], rays)  # (..., 3, HW)
    points = rays[..., :, None, :] * depths[..., None, :, None]  # (..., 3, D, HW)
    points = points + rel_pose[..., :3, 3:4][..., None, :]
    points = torch.einsum("...ij,...jdn->...idn", intrinsics_px, points)
    z = torch.clamp(points[..., 2:3, :, :], min=clamp_min_depth)
    xy = points[..., :2, :, :] / z
    x01 = xy[..., 0, :, :] / (w - 1)
    y01 = xy[..., 1, :, :] / (h - 1)
    return torch.stack([x01, y01], dim=-1)


def inverse_depth_candidates(near: torch.Tensor, far: torch.Tensor, num_samples: int) -> torch.Tensor:
    """D disparities linearly spaced in inverse depth between 1/far and 1/near."""
    lo = 1.0 / far
    hi = 1.0 / near
    t = torch.linspace(0.0, 1.0, num_samples, dtype=near.dtype, device=near.device)
    return lo[..., None] + t * (hi - lo)[..., None]


def project_rays(
    origins: torch.Tensor,  # (..., 3) world
    directions: torch.Tensor,  # (..., 3) world, unit
    extrinsics: torch.Tensor,  # (..., 4, 4) camera-to-world of the camera projected into
    intrinsics: torch.Tensor,  # (..., 3, 3) normalized
    near: torch.Tensor,  # (...) the segment's ends: origin + t direction, t in [near, far]
    far: torch.Tensor,  # (...)
    epsilon: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The segments projected into the cameras, clipped to the image and to
    the space in front of the camera: (xy_min, xy_max, on_image), the
    image coordinates (..., 2) of the clipped segment's near and far ends
    and whether any of the segment lands on the image [0, 1]^2.

    In camera coordinates a point of the segment is X(t) = o + t d and its
    image point (x, y) = (K X)_xy / (K X)_z. Each bound is linear in t once
    multiplied by (K X)_z: (K X)_z >= epsilon (in front), (K X)_x >= 0,
    (K X)_z - (K X)_x >= 0 (x <= 1), and the same for y. So the part of the
    segment on the image is one interval [t0, t1] of [near, far], and its
    ends lie on the image's border, or are the near and far points. Where
    no part lands on the image, t0 > t1 and the ends are meaningless."""
    w2c = torch.linalg.inv(extrinsics)
    o = transform_rigid(homogenize_points(origins), w2c)[..., :3]
    d = transform_rigid(homogenize_vectors(directions), w2c)[..., :3]
    po = torch.matmul(intrinsics, o[..., None])[..., 0]
    pd = torch.matmul(intrinsics, d[..., None])[..., 0]
    # Each bound as a + b t >= 0.
    a = torch.stack([po[..., 2] - epsilon, po[..., 0], po[..., 2] - po[..., 0], po[..., 1], po[..., 2] - po[..., 1]], -1)
    b = torch.stack([pd[..., 2], pd[..., 0], pd[..., 2] - pd[..., 0], pd[..., 1], pd[..., 2] - pd[..., 1]], -1)
    root = -a / torch.where(b == 0, torch.ones_like(b), b)
    inf = torch.full_like(root, float("inf"))
    t0 = torch.maximum(near, torch.where(b > 0, root, -inf).amax(-1))
    t1 = torch.minimum(far, torch.where(b < 0, root, inf).amin(-1))
    never = ((b == 0) & (a < 0)).any(-1)  # a bound the whole line breaks
    on_image = (t0 <= t1) & ~never

    def image_point(t: torch.Tensor) -> torch.Tensor:
        p = po + t[..., None] * pd
        return p[..., :2] / p[..., 2:]

    return image_point(t0), image_point(t1), on_image


def triangulate_depth(
    origins: torch.Tensor,  # (..., 3) world
    directions: torch.Tensor,  # (..., 3) world, unit
    xy: torch.Tensor,  # (..., 2) image points of another camera
    extrinsics: torch.Tensor,  # (..., 4, 4) that camera's, camera-to-world
    intrinsics: torch.Tensor,  # (..., 3, 3) normalized
) -> torch.Tensor:
    """The distance t along each ray (origin + t direction) of its point
    closest to the other camera's ray through `xy` (..., the two rays' common
    perpendicular). The directions' lengths enter as they are: a camera's
    rotation read from float32 is orthonormal only to ~1e-7, and near-parallel
    rays amplify that. Parallel rays give NaN or +-inf."""
    o2, d2 = get_world_rays(xy, extrinsics, intrinsics)
    w0 = origins - o2
    a = (directions * directions).sum(-1)
    b = (directions * d2).sum(-1)
    c = (d2 * d2).sum(-1)
    d = (directions * w0).sum(-1)
    e = (d2 * w0).sum(-1)
    return (b * e - c * d) / (a * c - b * b)


def depth_to_relative_disparity(depth: torch.Tensor, near: torch.Tensor, far: torch.Tensor) -> torch.Tensor:
    """1 at `near`, 0 at `far`, linear in disparity."""
    return 1.0 - (1.0 / depth - 1.0 / far) / (1.0 / near - 1.0 / far)
