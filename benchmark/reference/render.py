"""The plain renderer: Gaussians and target cameras -> colours, pixel by pixel.

The semantics of the port's splatting decoder (`decode_splatting` over
`render`): each camera's translation and the Gaussians rescaled by 1/near,
EWA projection (ops/rasterizer/projection.py, frozen), the Gaussians taken
in stable depth order, and every pixel composited front to back over every
Gaussian while its transmittance before the Gaussian is at least 1e-4, the
background added under what is left. No tiles, no lists and no kernels: a
band of rows at a time, over the Gaussians whose screen circle reaches the
band (every other Gaussian has alpha exactly 0 there, so leaving it out
changes no product).

`render_views` also counts the (pixel, Gaussian) pairs that the blend acts
on: alpha above 0 while the pixel is live.
"""

from __future__ import annotations

import torch

from .geometry.projection import get_fov
from .ops.rasterizer.projection import ProjectedGaussians, gaussian_alpha, pixel_centers, project_gaussians

TRANSMITTANCE_EPS = 1e-4


def project_view(means, covariances, harmonics, opacities, extrinsics, intrinsics, near, image_shape) -> ProjectedGaussians:
    """One camera: means (G, 3), covariances (G, 3, 3), harmonics (G, 3, n),
    opacities (G,), extrinsics (4, 4), intrinsics (3, 3), near () ->
    ProjectedGaussians of one view, scale-invariant as the decoder renders."""
    scale = 1.0 / near
    extr = extrinsics.clone()
    extr[:3, 3] = extr[:3, 3] * scale
    fov = get_fov(intrinsics[None])
    proj = project_gaussians(
        (means * scale)[None], (covariances * scale**2)[None], harmonics[None], opacities[None], extr[None],
        torch.tan(0.5 * fov[:, 0]), torch.tan(0.5 * fov[:, 1]), image_shape,
    )
    return proj.view(0)


def _band(px, conic, mean2d, opacity, radius, color, background):
    """Colours (P, 3) of the pixels `px` (P, 2) over depth-ordered Gaussians,
    and the count of kept pairs."""
    alpha = gaussian_alpha(conic[None], mean2d[None], opacity[None], px[:, None, :], radius[None])
    t_before = torch.cat([torch.ones_like(alpha[:, :1]), torch.cumprod(1.0 - alpha, dim=-1)[:, :-1]], dim=-1)
    live = t_before >= TRANSMITTANCE_EPS
    contrib = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
    t_final = torch.prod(torch.where(live, 1.0 - alpha, torch.ones_like(alpha)), dim=-1)
    band = torch.matmul(contrib, color) + t_final[:, None] * background[None, :]
    return band, (live & (alpha > 0)).sum()


def composite_view(proj: ProjectedGaussians, image_shape, background: torch.Tensor, rows: int = 8):
    """(h, w, 3) colours and the count of kept pairs of one projected view.
    Differentiable in the projected Gaussians and the background: with
    gradients on, each band is recomputed in the backward (checkpointed), so
    that a band's (pixel, Gaussian) tables are never all held at once."""
    from torch.utils.checkpoint import checkpoint

    h, w = image_shape
    depth_key = torch.where(proj.valid, proj.depth, torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(depth_key, stable=True)
    live_g = (proj.valid & (proj.opacity > 0))[order]
    order = order[live_g]
    mean2d, conic, radius = proj.mean2d[order], proj.conic[order], proj.radius[order]
    opacity, color = proj.opacity[order], proj.rgb[order]
    pixels = pixel_centers(image_shape, device=mean2d.device)
    grad = torch.is_grad_enabled()
    bands, kept = [], 0
    reach_x = (mean2d[:, 0] + radius >= 0) & (mean2d[:, 0] - radius <= w - 1)
    for y0 in range(0, h, rows):
        y1 = min(y0 + rows, h) - 1
        sel = reach_x & (mean2d[:, 1] + radius >= y0) & (mean2d[:, 1] - radius <= y1)
        args = (pixels[y0 : y1 + 1].reshape(-1, 2), conic[sel], mean2d[sel], opacity[sel], radius[sel], color[sel], background)
        band, k = checkpoint(_band, *args, use_reentrant=False) if grad else _band(*args)
        bands.append(band.reshape(y1 + 1 - y0, w, -1))
        kept = kept + k
    return torch.cat(bands), int(kept)


def render_views(gaussians, extrinsics, intrinsics, near, image_shape, background) -> tuple[torch.Tensor, int]:
    """Colours (t, h, w, 3) of one scene's Gaussians (means (G, 3), covariances,
    harmonics, opacities) in t cameras (extrinsics (t, 4, 4), intrinsics
    (t, 3, 3), near (t,)), and the kept pairs over all t views."""
    means, covariances, harmonics, opacities = gaussians
    images, kept = [], 0
    for i in range(extrinsics.shape[0]):
        proj = project_view(means, covariances, harmonics, opacities, extrinsics[i], intrinsics[i], near[i], image_shape)
        color, k = composite_view(proj, image_shape, background)
        images.append(color)
        kept += k
    return torch.stack(images), kept
