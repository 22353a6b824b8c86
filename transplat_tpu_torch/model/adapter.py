"""Raw network outputs -> world-space Gaussians (counterpart of
transplat_tpu/model/adapter.py): sigmoid scale mapping x depth x pixel-size
multiplier, quaternion normalize, SH damping mask, covariance rotated to
world, means from camera rays, SH rotated by the camera-to-world rotation.

`adapt_gaussians` is the plain version. `adapt_gaussians_fused` launches the
hand-written kernel csrc/gaussian_adapter.cu, which does the encoder's whole
stage 5 (the pixel offsets and the opacity too) in one launch and writes the
Gaussians' layouts; the encoder takes it where `kernels.kernel_route` says.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
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


def adapt_gaussians_fused(
    cfg: GaussianAdapterCfg,
    extrinsics: torch.Tensor,  # (b, v, 4, 4)
    intrinsics: torch.Tensor,  # (b, v, 3, 3) normalized
    raw: torch.Tensor,  # (b, v, r, 2 + d_in): pixel offsets, then adapt_gaussians' raw channels; any strides
    depths: torch.Tensor,  # (b, v, r, s): s Gaussians a pixel
    densities: torch.Tensor,  # (b, v, r, s)
    opacity_exponent: float,  # model/encoder.py opacity_exponent at the step
    gaussians_per_pixel: int,  # every opacity is divided by it
    image_shape: tuple[int, int],
    with_aux: bool = False,
) -> dict:
    """The encoder's stage 5 in one launch of csrc/gaussian_adapter.cu:
    means (b, v*r*s, 3), covariances (b, v*r*s, 3, 3), harmonics (b, v*r*s,
    3, d_sh), opacities (b, v*r*s), and with `with_aux` scales (b, v*r*s, 3)
    and rotations (b, v*r*s, 4), in (view, pixel, sample) order, as the
    plain path computes them from the pixel grid, `map_pdf_to_opacity` and
    `adapt_gaussians`."""
    h, w = image_shape
    b, v = extrinsics.shape[:2] if extrinsics.ndim == 4 else (-1, -1)
    s = depths.shape[-1] if depths.ndim == 4 else -1
    want = {
        "extrinsics": (extrinsics, (b, v, 4, 4)), "intrinsics": (intrinsics, (b, v, 3, 3)),
        "raw": (raw, (b, v, h * w, 2 + cfg.d_in)), "depths": (depths, (b, v, h * w, s)),
        "densities": (densities, (b, v, h * w, s)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"adapt_gaussians_fused: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not 0 <= cfg.sh_degree <= 4:
        raise ValueError(f"adapt_gaussians_fused: SH degree {cfg.sh_degree} (the kernel takes 0-4)")
    for name, (t, _) in want.items():
        kernels.check_cuda_tensor(name, t, torch.float32, contiguous=name != "raw")
    if s < 1:
        raise ValueError(f"adapt_gaussians_fused: depths has shape {tuple(depths.shape)}, expected {(b, v, h * w, s)}")
    g = v * h * w * s
    shapes = {"means": (b, g, 3), "covariances": (b, g, 3, 3), "harmonics": (b, g, 3, cfg.d_sh), "opacities": (b, g)}
    if with_aux:
        shapes.update(scales=(b, g, 3), rotations=(b, g, 4))
    out = {k: torch.empty(shape, dtype=torch.float32, device=raw.device) for k, shape in shapes.items()}
    aux = [out[k].data_ptr() if with_aux else None for k in ("scales", "rotations")]
    kernels.call(
        "tp_gaussian_adapter", "gaussian_adapter",
        raw.data_ptr(), depths.data_ptr(), densities.data_ptr(), intrinsics.data_ptr(), extrinsics.data_ptr(),
        *(out[k].data_ptr() for k in ("means", "covariances", "harmonics", "opacities")), *aux,
        b, v, h, w, cfg.sh_degree, *raw.stride(),
        cfg.gaussian_scale_min, cfg.gaussian_scale_max - cfg.gaussian_scale_min,
        opacity_exponent, 1.0 / opacity_exponent, gaussians_per_pixel, s,
    )
    return out
