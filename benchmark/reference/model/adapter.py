"""Raw network outputs -> world-space Gaussians (counterpart of
transplat_tpu/model/adapter.py): sigmoid scale mapping x depth x pixel-size
multiplier, quaternion normalize, SH damping mask, covariance rotated to
world, means from camera rays, SH rotated by the camera-to-world rotation."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..geometry.gaussians import build_covariance
from ..geometry.projection import get_world_rays
from ..geometry.sh import rotate_sh


@dataclass(frozen=True)
class GaussianAdapterCfg:
    gaussian_scale_min: float = 0.5
    gaussian_scale_max: float = 15.0
    sh_degree: int = 4

    @property
    def d_sh(self) -> int:
        return (self.sh_degree + 1) ** 2

    @property
    def d_in(self) -> int:
        return 7 + 3 * self.d_sh


def sh_mask(sh_degree: int, device=None) -> torch.Tensor:
    """Damping of the view-dependent SH components."""
    mask = [1.0]
    for degree in range(1, sh_degree + 1):
        mask.extend([0.1 * 0.25**degree] * (2 * degree + 1))
    return torch.tensor(mask, dtype=torch.float32, device=device)


def adapt_gaussians(
    cfg: GaussianAdapterCfg,
    extrinsics: torch.Tensor,  # (b, v, 4, 4)
    intrinsics: torch.Tensor,  # (b, v, 3, 3) normalized
    coordinates: torch.Tensor,  # (b, v, r, 2) normalized xy ray coords
    depths: torch.Tensor,  # (b, v, r)
    opacities: torch.Tensor,  # (b, v, r)
    raw_gaussians: torch.Tensor,  # (b, v, r, 7 + 3 * d_sh)
    image_shape: tuple[int, int],
    eps: float = 1e-8,
) -> dict:
    """Returns means/covariances/harmonics/opacities/scales/rotations, each (b, v, r, ...)."""
    h, w = image_shape
    scales = raw_gaussians[..., :3]
    rotations = raw_gaussians[..., 3:7]
    sh = raw_gaussians[..., 7:]

    smin, smax = cfg.gaussian_scale_min, cfg.gaussian_scale_max
    scales = smin + (smax - smin) * torch.sigmoid(scales)
    pixel_size = torch.tensor([1.0 / w, 1.0 / h], dtype=scales.dtype, device=scales.device)
    k2x2_inv = torch.linalg.inv(intrinsics[..., :2, :2])
    multiplier = 0.1 * torch.matmul(k2x2_inv, pixel_size).sum(-1)
    scales = scales * depths[..., None] * multiplier[..., None, None]

    rotations = rotations / (torch.linalg.norm(rotations, dim=-1, keepdim=True) + eps)
    sh = sh.reshape(*sh.shape[:-1], 3, cfg.d_sh) * sh_mask(cfg.sh_degree, sh.device)

    covariances = build_covariance(scales, rotations)
    c2w_rot = extrinsics[..., None, :3, :3]  # broadcast over r
    covariances = torch.matmul(torch.matmul(c2w_rot, covariances), c2w_rot.transpose(-1, -2))

    origins, directions = get_world_rays(coordinates, extrinsics[:, :, None], intrinsics[:, :, None])
    means = origins + directions * depths[..., None]
    harmonics = rotate_sh(sh, c2w_rot[..., None, :, :])
    return {
        "means": means,
        "covariances": covariances,
        "harmonics": harmonics,
        "opacities": opacities,
        "scales": scales,
        "rotations": rotations,
    }
