"""Batched rendering API: projection -> tile binning -> tile compositing.

Counterpart of transplat_tpu/ops/rasterizer/api.py. Modes:

  * "auto"      the tile rasterizer; its kernels (K1 binning, K3
                compositing) launch for CUDA tensors, and their plain
                PyTorch versions run for CPU tensors
  * "reference" the naive per-pixel oracle

The port drops nothing at capacity, so `RenderOutput.overflow` is always 0.
The TPU kernels' tuning fields (capacity, chunk, stream_window, bin_chunk,
level_headroom, interpret, binning, max_tiles_per_gaussian, remat) have no
counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ...geometry.projection import get_fov
from .binning import bin_gaussians, sort_by_depth
from .composite import composite_tiles
from .projection import ProjectedGaussians, project_gaussians
from .reference import render_reference_view

MODES = ("auto", "reference")


@dataclass(frozen=True)
class RasterizeConfig:
    tile_size: int = 16
    mode: str = "auto"
    # "f32" only; the JAX package's forward-only "bf16" tier is not ported yet.
    precision: str = "f32"


class RenderOutput(NamedTuple):
    color: torch.Tensor  # (B, h, w, C)
    radii: torch.Tensor  # (B, G) screen radii (0 for invisible)
    overflow: torch.Tensor  # (B,) dropped pairs: always 0 in the port


def project_views(
    extrinsics, intrinsics, near, means, covariances, sh, opacities,
    image_shape: tuple[int, int], scale_invariant: bool = True,
) -> ProjectedGaussians:
    """Project (B, G) Gaussians into B cameras (optionally rescaled by 1/near)."""
    if scale_invariant:
        scale = 1.0 / near
        extrinsics = extrinsics.clone()
        extrinsics[:, :3, 3] = extrinsics[:, :3, 3] * scale[:, None]
        covariances = covariances * (scale**2)[:, None, None, None]
        means = means * scale[:, None, None]
    fov = get_fov(intrinsics)
    return project_gaussians(
        means, covariances, sh, opacities, extrinsics,
        torch.tan(0.5 * fov[:, 0]), torch.tan(0.5 * fov[:, 1]), image_shape,
    )


def rasterize(
    proj: ProjectedGaussians,
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (B, C)
    feature: torch.Tensor | None = None,  # (B, G, C) colour override
    cfg: "RasterizeConfig" = RasterizeConfig(),
) -> torch.Tensor:
    """Composite projected Gaussians into (B, h, w, C) images."""
    if cfg.precision != "f32":
        raise NotImplementedError(f"precision={cfg.precision!r}: only 'f32' is ported")
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}; expected one of {MODES}")
    if cfg.mode == "reference":
        return torch.stack(
            [
                render_reference_view(
                    proj.view(i), image_shape, background[i],
                    None if feature is None else feature[i],
                )
                for i in range(proj.depth.shape[0])
            ]
        )
    gfeat, colors = sort_by_depth(proj, feature)
    lists = bin_gaussians(gfeat, image_shape, cfg.tile_size)
    background = background.to(colors.dtype).contiguous()
    return composite_tiles(gfeat, colors, lists, background, image_shape, cfg.tile_size)


def render(
    extrinsics: torch.Tensor,  # (B, 4, 4) camera-to-world
    intrinsics: torch.Tensor,  # (B, 3, 3) normalized
    near: torch.Tensor,  # (B,)
    far: torch.Tensor,  # (B,)
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (B, 3)
    means: torch.Tensor,  # (B, G, 3)
    covariances: torch.Tensor,  # (B, G, 3, 3)
    sh: torch.Tensor,  # (B, G, 3, n_sh)
    opacities: torch.Tensor,  # (B, G)
    scale_invariant: bool = True,
    cfg: RasterizeConfig = RasterizeConfig(),
    feature: torch.Tensor | None = None,  # (B, G, C<=8) color override
) -> RenderOutput:
    """Render B views of B Gaussian sets. Returns colours (B, h, w, C)."""
    proj = project_views(
        extrinsics, intrinsics, near, means, covariances, sh, opacities,
        image_shape, scale_invariant,
    )
    color = rasterize(proj, image_shape, background, feature, cfg)
    radii = torch.where(proj.valid, proj.radius, torch.zeros_like(proj.radius))
    overflow = torch.zeros(means.shape[0], dtype=torch.int32, device=means.device)
    return RenderOutput(color=color, radii=radii, overflow=overflow)


def render_depth(
    extrinsics, intrinsics, near, far, image_shape, means, covariances, opacities,
    scale_invariant: bool = True,
    mode: str = "depth",
    cfg: RasterizeConfig = RasterizeConfig(),
) -> torch.Tensor:
    """Per-pixel expected depth (B, h, w) by compositing a 1-channel feature:
    depth / disparity / relative_disparity / log."""
    w2c = torch.linalg.inv(extrinsics)
    cam_z = (torch.einsum("bij,bgj->bgi", w2c[:, :3, :3], means) + w2c[:, None, :3, 3])[..., 2]
    if mode == "depth":
        feat = cam_z
    elif mode == "disparity":
        feat = 1.0 / cam_z
    elif mode == "relative_disparity":
        near_ = near[:, None]
        far_ = far[:, None]
        feat = 1.0 - (1.0 / cam_z - 1.0 / far_) / (1.0 / near_ - 1.0 / far_)
    elif mode == "log":
        feat = torch.log(torch.minimum(torch.maximum(cam_z, near[:, None]), far[:, None]))
    else:
        raise ValueError(f"unknown depth mode {mode}")
    dummy_sh = torch.zeros(means.shape[:2] + (3, 1), dtype=means.dtype, device=means.device)
    bg = torch.zeros((means.shape[0], 1), dtype=means.dtype, device=means.device)
    out = render(
        extrinsics, intrinsics, near, far, image_shape, bg, means, covariances,
        dummy_sh, opacities, scale_invariant=scale_invariant, cfg=cfg,
        feature=feat[..., None].contiguous(),
    )
    return out.color[..., 0]
