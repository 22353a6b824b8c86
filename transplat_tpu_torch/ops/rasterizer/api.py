"""Batched rendering API: projection -> tile binning -> tile compositing.

Counterpart of transplat_tpu/ops/rasterizer/api.py. Modes:

  * "auto"      the tile rasterizer; its kernels (K1 binning, K3
                compositing, and in the backward K4 and K2) launch for CUDA
                tensors, and their plain PyTorch versions run for CPU tensors
  * "reference" the naive per-pixel oracle (differentiable by autograd)

`render` projects inside the span `render.project`; the tile path sorts,
bins and composites inside `render.sort`, `render.bin` (K1, and the host
read of the number of pairs) and `render.composite` (K3's forward), and
counts its pairs and views (utils/trace.py `counters`: `render.pairs`,
`render.views`).

The projection takes one of two routes (projection.py), counted per render
as `render.project.fused` / `render.project.plain`:

  * the kernel (csrc/project.cu, one launch): in "auto" mode where every
    input is float32 on the card and no gradient is recorded. It packs the
    depth sort's keys, rows, colours and radii with no host round trip; the
    sort and the gathers follow, and nothing before K1's pair-total read
    copies between host and card.
  * the plain chain (`project_views`, `sort_by_depth`): on the CPU, under
    autograd (training), and in "reference" mode.

A CUDA call that can take the kernel launches it or raises; nothing falls
back. Where a gradient is recorded only the plain chain runs, so a render is
differentiable in the Gaussians and the background on both devices: the
gradient reaches the projection and the depth sort's gather by autograd,
and the tile lists are constants.

`render` takes the Gaussians as b sets (b, G, ...) for B = b * views cameras,
camera i seeing set i // views (views 1 where b = B): the kernel reads a set
once for all its cameras, and the plain chain repeats it for each.

The port drops nothing at capacity, so `RenderOutput.overflow` is always 0.
The TPU kernels' tuning fields (capacity, chunk, stream_window, bin_chunk,
level_headroom, interpret, binning, max_tiles_per_gaussian, remat) have no
counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ...utils import trace
from .binning import bin_gaussians, sort_by_depth, sort_rows
from .composite import composite_tiles
from .projection import (
    ProjectedGaussians,
    project_rows_kernel,
    project_views,
    projection_kernel_applies,
    repeat_sets,
    views_per_set,
)
from .reference import render_reference_view

MODES = ("auto", "reference")


PRECISIONS = ("f32", "bf16")


@dataclass(frozen=True)
class RasterizeConfig:
    tile_size: int = 16
    mode: str = "auto"
    # "f32": the differentiable default. "bf16": the JAX package's forward-only
    # inference tier, which routes its TPU matmuls in bf16. The port has no
    # such routing: the tier runs the float32 kernels (its colours equal the
    # "f32" forward bit for bit) and, as in JAX, refuses autograd.
    precision: str = "f32"


class RenderOutput(NamedTuple):
    color: torch.Tensor  # (B, h, w, C)
    radii: torch.Tensor  # (B, G) screen radii (0 for invisible)
    overflow: torch.Tensor  # (B,) dropped pairs: always 0 in the port


def _check_cfg(cfg: "RasterizeConfig", tensors) -> None:
    if cfg.precision not in PRECISIONS:
        raise ValueError(f"unknown precision {cfg.precision!r}; expected one of {PRECISIONS}")
    if cfg.precision == "bf16" and torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise NotImplementedError(
            "precision='bf16' rendering is an inference-only tier: differentiate with the default precision='f32'"
        )
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}; expected one of {MODES}")


def _bin_and_composite(gfeat, colors, image_shape, background, cfg: "RasterizeConfig", deterministic: bool):
    """Depth-sorted rows and colours -> (B, h, w, C) images: K1's lists, then K3."""
    with trace.span("render.bin"), torch.no_grad():  # the lists are integers: constants of the gradient
        lists = bin_gaussians(gfeat, image_shape, cfg.tile_size)
    trace.count("render.pairs", lists.idx.numel())
    trace.count("render.views", gfeat.shape[0])
    background = background.to(colors.dtype).contiguous()
    with trace.span("render.composite"):
        return composite_tiles(gfeat, colors, lists, background, image_shape, cfg.tile_size, deterministic)


def rasterize(
    proj: ProjectedGaussians,
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (B, C)
    feature: torch.Tensor | None = None,  # (B, G, C) colour override
    cfg: "RasterizeConfig" = RasterizeConfig(),
    deterministic: bool = False,
) -> torch.Tensor:
    """Composite projected Gaussians into (B, h, w, C) images; `deterministic`
    makes the backward repeat its bits (K2's sorted mode)."""
    _check_cfg(cfg, (*proj, background, feature))
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
    with trace.span("render.sort"):
        gfeat, colors = sort_by_depth(proj, feature)
    return _bin_and_composite(gfeat, colors, image_shape, background, cfg, deterministic)


def render(
    extrinsics: torch.Tensor,  # (B, 4, 4) camera-to-world
    intrinsics: torch.Tensor,  # (B, 3, 3) normalized
    near: torch.Tensor,  # (B,)
    far: torch.Tensor,  # (B,)
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (B, 3)
    means: torch.Tensor,  # (b, G, 3): b sets, B = b * views
    covariances: torch.Tensor,  # (b, G, 3, 3)
    sh: torch.Tensor,  # (b, G, 3, n_sh)
    opacities: torch.Tensor,  # (b, G)
    scale_invariant: bool = True,
    cfg: RasterizeConfig = RasterizeConfig(),
    feature: torch.Tensor | None = None,  # (B, G, C<=8) color override
    deterministic: bool = False,  # a backward that repeats its bits (K2's sorted mode)
) -> RenderOutput:
    """Render B views of b Gaussian sets, camera i seeing set i // (B / b).
    Returns colours (B, h, w, C). The projection takes the kernel or the
    plain chain (the module's docstring says which call takes which)."""
    views = views_per_set(extrinsics.shape[0], means.shape[0])
    gaussians = (means, covariances, sh, opacities)
    if cfg.mode != "auto" or not projection_kernel_applies(
        extrinsics, intrinsics, near, background, feature, means, covariances, opacities, sh=sh
    ):
        trace.count("render.project.plain", 1)
        with trace.span("render.project"):
            proj = project_views(
                extrinsics, intrinsics, near, *(repeat_sets(x, views) for x in gaussians), image_shape, scale_invariant,
            )
        color = rasterize(proj, image_shape, background, feature, cfg, deterministic)
        radii = torch.where(proj.valid, proj.radius, torch.zeros_like(proj.radius))
    else:
        _check_cfg(cfg, ())
        trace.count("render.project.fused", 1)
        with trace.span("render.project"):
            keys, rows, rgb, radii = project_rows_kernel(
                *(x.contiguous() for x in (extrinsics, intrinsics, near, *gaussians)), image_shape, scale_invariant,
                with_color=feature is None,
            )
        with trace.span("render.sort"):
            gfeat, colors = sort_rows(keys, rows, rgb if feature is None else feature)
        color = _bin_and_composite(gfeat, colors, image_shape, background, cfg, deterministic)
    overflow = torch.zeros(extrinsics.shape[0], dtype=torch.int32, device=means.device)
    return RenderOutput(color=color, radii=radii, overflow=overflow)


def render_depth(
    extrinsics, intrinsics, near, far, image_shape, means, covariances, opacities,
    scale_invariant: bool = True,
    mode: str = "depth",
    cfg: RasterizeConfig = RasterizeConfig(),
) -> torch.Tensor:
    """Per-pixel expected depth (B, h, w) by compositing a 1-channel feature:
    depth / disparity / relative_disparity / log. The Gaussians are b sets
    for B = b * views cameras, as in `render`. The feature is plain PyTorch
    (the camera-space depth through torch.linalg.inv: a differentiable
    input of the composite); its projection and composite are `render`'s,
    the kernel where `render` takes it."""
    w2c = torch.linalg.inv(extrinsics)
    views_means = repeat_sets(means, views_per_set(extrinsics.shape[0], means.shape[0]))
    cam_z = (torch.einsum("bij,bgj->bgi", w2c[:, :3, :3], views_means) + w2c[:, None, :3, 3])[..., 2]
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
    bg = torch.zeros((extrinsics.shape[0], 1), dtype=means.dtype, device=means.device)
    out = render(
        extrinsics, intrinsics, near, far, image_shape, bg, means, covariances,
        dummy_sh, opacities, scale_invariant=scale_invariant, cfg=cfg,
        feature=feat[..., None].contiguous(),
    )
    return out.color[..., 0]
