"""Gaussian primitive math: quaternion -> rotation, covariance construction.

Counterpart of transplat_tpu/geometry/gaussians.py (quaternions in xyzw
order, covariance = R S S^T R^T).
"""

from __future__ import annotations

import torch


def quaternion_to_matrix(quaternions: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Convert (..., 4) xyzw quaternions to (..., 3, 3) rotation matrices."""
    i, j, k, r = torch.unbind(quaternions, dim=-1)
    two_s = 2.0 / (torch.sum(quaternions * quaternions, dim=-1) + eps)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(*o.shape[:-1], 3, 3)


def build_covariance(scale: torch.Tensor, rotation_xyzw: torch.Tensor) -> torch.Tensor:
    """Covariance = R diag(s^2) R^T for (..., 3) scales, (..., 4) quats."""
    rotation = quaternion_to_matrix(rotation_xyzw)
    scaled = rotation * (scale**2)[..., None, :]
    return torch.matmul(scaled, rotation.transpose(-1, -2))


def covariance_upper_triangle(covariances: torch.Tensor) -> torch.Tensor:
    """Pack (..., 3, 3) symmetric covariances into (..., 6) upper triangles
    in row-major order (xx, xy, xz, yy, yz, zz)."""
    rows, cols = torch.triu_indices(3, 3, device=covariances.device)
    return covariances[..., rows, cols]


def covariance_from_upper_triangle(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`covariance_upper_triangle`."""
    xx, xy, xz, yy, yz, zz = torch.unbind(packed, dim=-1)
    return torch.stack(
        [torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1), torch.stack([xz, yz, zz], -1)], dim=-2
    )
