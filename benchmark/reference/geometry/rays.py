"""Ray segments seen from another camera, for pixelSplat's epipolar sampler
(model/epipolar.py): the segment's part inside the camera's view frustum,
its ends' image points, and the depth along a ray of a point seen in the
other view.

Conventions as projection.py: camera-to-world extrinsics, intrinsics
normalized to [0, 1] image coordinates.
"""

from __future__ import annotations

import torch

from .projection import get_world_rays, homogenize_points

CORNERS = ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0))


def frustum_planes(extrinsics: torch.Tensor, intrinsics: torch.Tensor, epsilon: float):
    """The view frustum of each camera as half-spaces n . X + c >= 0 in world
    space: the four planes through the camera centre and two neighbouring
    image corners' rays, each facing the principal ray, and the plane
    epsilon in front of the camera. Returns normals (..., 5, 3), offsets (..., 5)."""
    centre = extrinsics[..., :3, 3]
    rot = extrinsics[..., :3, :3]
    k_inv = torch.linalg.inv(intrinsics)

    def world_dir(x: float, y: float) -> torch.Tensor:
        p = torch.tensor([x, y, 1.0], dtype=intrinsics.dtype, device=intrinsics.device)
        return torch.matmul(rot, torch.matmul(k_inv, p)[..., None])[..., 0]

    corners = [world_dir(x, y) for x, y in CORNERS]
    principal = world_dir(0.5, 0.5)
    normals = []
    for i in range(4):
        n = torch.linalg.cross(corners[i], corners[(i + 1) % 4])
        facing = (n * principal).sum(-1, keepdim=True)
        normals.append(torch.where(facing < 0, -n, n))
    forward = rot[..., :, 2]  # the camera's z axis in world space
    normals.append(forward)
    normals = torch.stack(normals, dim=-2)
    offsets = -(normals * centre[..., None, :]).sum(-1)
    offsets = torch.cat([offsets[..., :4], offsets[..., 4:] - epsilon], dim=-1)
    return normals, offsets


def project_rays(origins, directions, extrinsics, intrinsics, near, far, epsilon: float = 1e-6):
    """Segments origin + t direction, t in [near, far] (origins, directions
    (..., 3); extrinsics (..., 4, 4); intrinsics (..., 3, 3); near, far
    (...)), cut to the camera's frustum. Returns the image points (..., 2) of
    the cut segment's near and far ends and whether it is not empty."""
    normals, offsets = frustum_planes(extrinsics, intrinsics, epsilon)
    along = (normals * directions[..., None, :]).sum(-1)  # n . D
    at_origin = (normals * origins[..., None, :]).sum(-1) + offsets  # n . O + c
    lo, hi = near.clone(), far.clone()
    empty = torch.zeros_like(near, dtype=torch.bool)
    for i in range(normals.shape[-2]):
        a, b = at_origin[..., i], along[..., i]
        cut = -a / torch.where(b == 0, torch.ones_like(b), b)
        lo = torch.where(b > 0, torch.maximum(lo, cut), lo)
        hi = torch.where(b < 0, torch.minimum(hi, cut), hi)
        empty = empty | ((b == 0) & (a < 0))
    valid = (lo <= hi) & ~empty
    return image_point(origins + lo[..., None] * directions, extrinsics, intrinsics), \
        image_point(origins + hi[..., None] * directions, extrinsics, intrinsics), valid


def image_point(points, extrinsics, intrinsics):
    """World points (..., 3) -> image points (..., 2): K X / (K X)_z in the
    camera's frame, with no epsilon in the division (projection.py's
    `project` adds one, which moves a far point's image point by ~1e-7)."""
    cam = torch.matmul(torch.linalg.inv(extrinsics), homogenize_points(points)[..., None])[..., :3, :]
    pix = torch.matmul(intrinsics, cam)[..., 0]
    return pix[..., :2] / pix[..., 2:]


def depth_along_ray(origins, directions, xy, extrinsics, intrinsics) -> torch.Tensor:
    """For each ray (origins, unit directions (..., 3)) the t of its point
    nearest to the ray of the other camera (extrinsics, intrinsics) through
    its image point `xy` (..., 2): the 2 x 2 normal equations of t1 D1 - t2
    D2 = O2 - O1, by Cramer's rule."""
    o2, d2 = get_world_rays(xy, extrinsics, intrinsics)
    rhs = o2 - origins
    a11 = (directions * directions).sum(-1)
    a12 = -(directions * d2).sum(-1)
    a22 = (d2 * d2).sum(-1)
    b1 = (directions * rhs).sum(-1)
    b2 = -(d2 * rhs).sum(-1)
    return (b1 * a22 - a12 * b2) / (a11 * a22 - a12 * a12)
