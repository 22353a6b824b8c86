"""Splatting decoder: Gaussians + target cameras -> rendered views.

Counterpart of transplat_tpu/model/decoder.py (`decode_splatting`): all
(batch x target view) cameras are rendered in one batched call. The JAX
package's view-sharded multi-device branch is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from ..ops.rasterizer.api import RasterizeConfig, render, render_depth
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
) -> DecoderOutput:
    b, tv = extrinsics.shape[:2]
    g = gaussians.means.shape[1]

    def flatten_cam(x):
        return x.reshape(b * tv, *x.shape[2:])

    def repeat_g(x):
        return x[:, None].expand(b, tv, *x.shape[1:]).reshape(b * tv, *x.shape[1:])

    bg = torch.tensor(cfg.background_color, dtype=torch.float32, device=extrinsics.device).expand(b * tv, 3)
    out = render(
        flatten_cam(extrinsics), flatten_cam(intrinsics), flatten_cam(near), flatten_cam(far), image_shape, bg,
        repeat_g(gaussians.means), repeat_g(gaussians.covariances), repeat_g(gaussians.harmonics),
        repeat_g(gaussians.opacities), cfg=cfg.rasterize,
    )
    depth = None
    if depth_mode is not None:
        depth = render_depth(
            flatten_cam(extrinsics), flatten_cam(intrinsics), flatten_cam(near), flatten_cam(far), image_shape,
            repeat_g(gaussians.means), repeat_g(gaussians.covariances), repeat_g(gaussians.opacities),
            mode=depth_mode, cfg=cfg.rasterize,
        ).reshape(b, tv, *image_shape)
    return DecoderOutput(
        color=out.color.reshape(b, tv, *image_shape, 3),
        depth=depth,
        radii=out.radii.reshape(b, tv, g),
        overflow=out.overflow.reshape(b, tv),
    )
