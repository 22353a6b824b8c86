"""View-overlap estimation for evaluation-index generation.

Counterpart of transplat_tpu/geometry/overlap.py on torch tensors: whether a
ray ever projects inside another view's image is decided by projecting it at
log-spaced depths (the image bounds are convex, so dense samples decide it).
"""

from __future__ import annotations

import torch

from .projection import get_world_rays, project, sample_image_grid


def rays_overlap_image(
    origins: torch.Tensor,
    directions: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    t_min: float = 1e-3,
    t_max: float = 1e4,
    num_samples: int = 48,
    epsilon: float = 1e-6,
) -> torch.Tensor:
    """For rays (N, 3) + (N, 3): does each ray ever project inside the image? (N,) bool."""
    ts = torch.logspace(torch.log10(torch.tensor(t_min)), torch.log10(torch.tensor(t_max)), num_samples,
                        dtype=origins.dtype, device=origins.device)
    points = origins[:, None, :] + ts[None, :, None] * directions[:, None, :]
    xy, in_front = project(points, extrinsics, intrinsics)
    inside = (xy >= -epsilon).all(-1) & (xy <= 1 + epsilon).all(-1) & in_front
    return inside.any(dim=1)


def view_overlap(
    extrinsics_a: torch.Tensor,
    intrinsics_a: torch.Tensor,
    extrinsics_b: torch.Tensor,
    intrinsics_b: torch.Tensor,
    grid_shape: tuple[int, int] = (32, 32),
) -> torch.Tensor:
    """Fraction of view A's rays that enter view B's frustum (a 0-dim tensor)."""
    xy, _ = sample_image_grid(grid_shape, device=extrinsics_a.device, dtype=extrinsics_a.dtype)
    origins, directions = get_world_rays(xy.reshape(-1, 2), extrinsics_a, intrinsics_a)
    return rays_overlap_image(origins, directions, extrinsics_b, intrinsics_b).float().mean()
