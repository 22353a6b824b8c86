"""Camera geometry on torch tensors.

Counterpart of transplat_tpu/geometry/projection.py:

  * extrinsics are OpenCV-style camera-to-world 4x4 matrices
  * intrinsics are 3x3, normalized to [0, 1] image coordinates unless noted
  * pixel-center convention: coordinate (x + 0.5)/W, (y + 0.5)/H
"""

from __future__ import annotations

import torch

from ..utils.constants import device_constant

_EPS = 1.1920929e-07  # float32 machine epsilon


def homogenize_points(points: torch.Tensor) -> torch.Tensor:
    """(..., d) xyz -> (..., d+1) xyz1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def homogenize_vectors(vectors: torch.Tensor) -> torch.Tensor:
    """(..., d) xyz -> (..., d+1) xyz0."""
    return torch.cat([vectors, torch.zeros_like(vectors[..., :1])], dim=-1)


def transform_rigid(coords: torch.Tensor, transformation: torch.Tensor) -> torch.Tensor:
    """Apply (..., d, d) transforms to (..., d) homogeneous coords (broadcasting)."""
    return torch.matmul(transformation, coords.unsqueeze(-1)).squeeze(-1)


def transform_cam2world(coords: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    return transform_rigid(coords, extrinsics)


def transform_world2cam(coords: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    return transform_rigid(coords, torch.linalg.inv(extrinsics))


def project_camera_space(points: torch.Tensor, intrinsics: torch.Tensor, epsilon: float = _EPS,
                         infinity: float = 1e8) -> torch.Tensor:
    """Perspective-divide then apply intrinsics. points: (..., 3) -> (..., 2)."""
    z = points[..., -1:]
    points = points / (z + epsilon)
    points = torch.nan_to_num(points, posinf=infinity, neginf=-infinity)
    points = transform_rigid(points, intrinsics)
    return points[..., :-1]


def project(points: torch.Tensor, extrinsics: torch.Tensor, intrinsics: torch.Tensor, epsilon: float = _EPS):
    """World points -> normalized image xy. Returns (xy, in_front_of_camera)."""
    points = homogenize_points(points)
    points = transform_world2cam(points, extrinsics)[..., :-1]
    in_front = points[..., -1] >= 0
    return project_camera_space(points, intrinsics, epsilon=epsilon), in_front


def unproject(coordinates: torch.Tensor, z: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Normalized image xy + depth -> camera-space xyz."""
    coordinates = homogenize_points(coordinates)
    directions = transform_rigid(coordinates, torch.linalg.inv(intrinsics))
    return directions * z[..., None]


def get_world_rays(coordinates, extrinsics, intrinsics):
    """Normalized image xy -> (origins, unit directions) in world space."""
    directions = unproject(coordinates, torch.ones_like(coordinates[..., 0]), intrinsics)
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    directions = homogenize_vectors(directions)
    directions = transform_cam2world(directions, extrinsics)[..., :-1]
    origins = extrinsics[..., :-1, -1].expand(directions.shape)
    return origins, directions


def sample_image_grid(shape: tuple[int, int], device=None, dtype=torch.float32):
    """Pixel-center image grid.

    Returns coordinates (h, w, 2) float xy in (0, 1) and indices (h, w, 2)
    int (row, col).
    """
    h, w = shape
    row = torch.arange(h, device=device)
    col = torch.arange(w, device=device)
    indices = torch.stack(torch.meshgrid(row, col, indexing="ij"), dim=-1)
    y = (row.to(dtype) + 0.5) / h
    x = (col.to(dtype) + 0.5) / w
    ys, xs = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xs, ys], dim=-1), indices


def get_fov(intrinsics: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) normalized intrinsics -> (..., 2) [fov_x, fov_y] in radians."""
    intrinsics_inv = torch.linalg.inv(intrinsics)

    def ray(v):
        vec = torch.tensor(v, dtype=intrinsics.dtype, device=intrinsics.device)
        vec = transform_rigid(vec, intrinsics_inv)
        return vec / torch.linalg.norm(vec, dim=-1, keepdim=True)

    left, right = ray([0.0, 0.5, 1.0]), ray([1.0, 0.5, 1.0])
    top, bottom = ray([0.5, 0.0, 1.0]), ray([0.5, 1.0, 1.0])
    fov_x = torch.arccos(torch.sum(left * right, dim=-1))
    fov_y = torch.arccos(torch.sum(top * bottom, dim=-1))
    return torch.stack([fov_x, fov_y], dim=-1)


def unnormalize_intrinsics(intrinsics: torch.Tensor, image_shape: tuple[int, int]) -> torch.Tensor:
    """Scale [0,1]-normalized intrinsics to pixel units for (h, w) images."""
    h, w = image_shape
    return intrinsics * device_constant(((w,), (h,), (1.0,)), intrinsics)
