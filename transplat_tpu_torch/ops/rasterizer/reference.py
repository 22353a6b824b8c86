"""Naive per-pixel compositor: the correctness oracle.

Counterpart of transplat_tpu/ops/rasterizer/reference.py. Composites every
Gaussian for every pixel in depth order: O(G * H * W), for tests and small
scenes only.
"""

from __future__ import annotations

import torch

from .projection import ProjectedGaussians, gaussian_alpha, pixel_centers

TRANSMITTANCE_EPS = 1e-4


def composite_pixels(
    proj: ProjectedGaussians,  # one view, (G, ...) fields
    order: torch.Tensor,  # (G,) depth-sorted indices
    pixel_xy: torch.Tensor,  # (P, 2)
    background: torch.Tensor,  # (C,)
    feature: torch.Tensor | None = None,  # (G, C) color override
):
    """Front-to-back composite in the given order. Returns (P, C) colors and
    (P,) final transmittance; a Gaussian contributes while T_before >= 1e-4."""
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    opacity = torch.where(proj.valid, proj.opacity, torch.zeros_like(proj.opacity))[order]
    radius = proj.radius[order]
    color = (proj.rgb if feature is None else feature)[order]

    alpha = gaussian_alpha(
        conic[None], mean2d[None], opacity[None], pixel_xy[:, None, :], radius[None]
    )  # (P, G)
    t_before = torch.cat(
        [torch.ones_like(alpha[:, :1]), torch.cumprod(1.0 - alpha, dim=-1)[:, :-1]], dim=-1
    )
    live = t_before >= TRANSMITTANCE_EPS
    contrib = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
    out = torch.matmul(contrib, color)
    t_final = torch.prod(torch.where(live, 1.0 - alpha, torch.ones_like(alpha)), dim=-1)
    out = out + t_final[:, None] * background[None, :]
    return out, t_final


def render_reference_view(
    proj: ProjectedGaussians,  # one view
    image_shape: tuple[int, int],
    background: torch.Tensor,
    feature: torch.Tensor | None = None,
    chunk: int = 4096,
) -> torch.Tensor:
    """Render one view with the naive compositor. Returns (h, w, C)."""
    h, w = image_shape
    depth_key = torch.where(proj.valid, proj.depth, torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(depth_key, stable=True)
    pixels = pixel_centers(image_shape, device=proj.depth.device).reshape(-1, 2)
    out = torch.cat(
        [
            composite_pixels(proj, order, pixels[i : i + chunk], background, feature)[0]
            for i in range(0, pixels.shape[0], chunk)
        ],
        dim=0,
    )
    return out.reshape(h, w, out.shape[-1])
