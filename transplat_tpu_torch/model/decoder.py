"""Splatting decoder: Gaussians + target cameras -> rendered views.

Counterpart of transplat_tpu/model/decoder.py (`decode_splatting`): all
(batch x target view) cameras are rendered in one batched call, each batch
entry's Gaussians handed to `render` once for its tv cameras (the
projection kernel reads them once; the plain chain repeats them a view).
The background is filled on the device: nothing is copied from the host.

With a mesh of sp > 1 (parallel/mesh.py), as the JAX package's shard_map
branch: each rank holds its slice of the Gaussian axis, all-gathers the four
fields once over its sp group (the only collective of the decode; its
backward sums the Gaussians' gradient over sp and keeps the rank's slice),
and renders its own tv / sp target views through the unchanged `render`.
Front-to-back compositing needs every Gaussian in each camera's depth order,
so the views are split and the Gaussians are not.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from ..ops.rasterizer.api import RasterizeConfig, render, render_depth
from ..parallel.mesh import gather_gaussians, view_slice
from .types import Gaussians


class DecoderOutput(NamedTuple):
    color: torch.Tensor  # (b, tv, h, w, 3)
    depth: torch.Tensor | None  # (b, tv, h, w) or None
    radii: torch.Tensor  # (b, tv, g)
    overflow: torch.Tensor  # (b, tv): always 0 (the port drops nothing)


@dataclass(frozen=True)
class DecoderCfg:
    background_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    rasterize: RasterizeConfig = field(default_factory=RasterizeConfig)


def decode_splatting(
    gaussians: Gaussians,
    extrinsics: torch.Tensor,  # (b, tv, 4, 4)
    intrinsics: torch.Tensor,  # (b, tv, 3, 3)
    near: torch.Tensor,  # (b, tv)
    far: torch.Tensor,  # (b, tv)
    image_shape: tuple[int, int],
    cfg: DecoderCfg = DecoderCfg(),
    depth_mode: str | None = None,
    deterministic_kernels: bool = False,
    mesh=None,
) -> DecoderOutput:
    """Render the Gaussians into every target camera; `deterministic_kernels`
    makes the colour's backward repeat its bits (K2's sorted mode).

    mesh: with sp > 1, `gaussians` is this rank's slice of the Gaussian axis
    (`parallel.constrain`). They are gathered, and the outputs hold the
    rank's own target views (`parallel.view_slice`: its tv / sp block when
    tv % sp == 0, else every view)."""
    if mesh is not None and mesh.sp > 1:
        gaussians = gather_gaussians(gaussians, mesh)
        views = view_slice(extrinsics.shape[1], mesh)
        extrinsics, intrinsics, near, far = (x[:, views] for x in (extrinsics, intrinsics, near, far))
    b, tv = extrinsics.shape[:2]
    g = gaussians.means.shape[1]

    def flatten_cam(x):
        return x.reshape(b * tv, *x.shape[2:])

    first = cfg.background_color[0]
    bg = torch.full((b * tv, 3), first, dtype=torch.float32, device=extrinsics.device)
    for c, value in enumerate(cfg.background_color):
        if value != first:
            bg[:, c] = value
    out = render(
        flatten_cam(extrinsics), flatten_cam(intrinsics), flatten_cam(near), flatten_cam(far), image_shape, bg,
        gaussians.means, gaussians.covariances, gaussians.harmonics, gaussians.opacities,
        cfg=cfg.rasterize, deterministic=deterministic_kernels,
    )
    depth = None
    if depth_mode is not None:
        depth = render_depth(
            flatten_cam(extrinsics), flatten_cam(intrinsics), flatten_cam(near), flatten_cam(far), image_shape,
            gaussians.means, gaussians.covariances, gaussians.opacities, mode=depth_mode, cfg=cfg.rasterize,
        ).reshape(b, tv, *image_shape)
    return DecoderOutput(
        color=out.color.reshape(b, tv, *image_shape, 3),
        depth=depth,
        radii=out.radii.reshape(b, tv, g),
        overflow=out.overflow.reshape(b, tv),
    )
