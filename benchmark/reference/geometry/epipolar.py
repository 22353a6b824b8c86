"""Plane-sweep / epipolar sampling geometry.

Counterpart of transplat_tpu/geometry/epipolar.py. Conventions:
  * pixel grid uses integer pixel coordinates 0..W-1 (no half-pixel shift)
  * returned sample locations are in [0, 1], normalized by (W-1, H-1)
"""

from __future__ import annotations

import torch


def relative_pose(extrinsics_ref: torch.Tensor, extrinsics_tgt: torch.Tensor) -> torch.Tensor:
    """Transform taking ref-camera points into tgt-camera coordinates."""
    return torch.matmul(torch.linalg.inv(extrinsics_tgt), extrinsics_ref)


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
    rays = torch.matmul(torch.linalg.inv(intrinsics_px), grid)
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
