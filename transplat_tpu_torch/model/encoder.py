"""EncoderTranSplat: posed context images -> per-pixel world Gaussians.

Counterpart of transplat_tpu/model/encoder.py: backbone (CNN + multi-view
Swin) -> frozen DAv2 mono prior -> depth predictor (epipolar deformable cost
volume) -> Gaussian adapter. The module starts in eval mode (BatchNorm
running statistics, no dropout) and honours train(): batch statistics, and
dropout masks from the generator given to forward. DAv2 is frozen: its
parameters take no gradient and it runs under no_grad.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch
from torch import nn

from ..geometry.projection import sample_image_grid, unnormalize_intrinsics
from ..ops.interpolate import resize_bilinear
from .adapter import GaussianAdapterCfg, adapt_gaussians
from .backbone.multiview import BackboneMultiview, normalize_images
from .dav2 import DAV2_CONFIGS, DepthAnythingV2
from .depth_predictor import DepthPredictor, img2world_matrices
from .types import Gaussians


@dataclass(frozen=True)
class OpacityMappingCfg:
    initial: float = 0.0
    final: float = 0.0
    warm_up: int = 1


@dataclass(frozen=True)
class EncoderCfg:
    d_feature: int = 128
    num_depth_candidates: int = 128
    num_surfaces: int = 1
    gaussians_per_pixel: int = 1
    num_context_views: int = 2
    downscale_factor: int = 4
    multiview_trans_attn_split: int = 2
    costvolume_unet_feat_dim: int = 128
    costvolume_unet_channel_mult: Sequence[int] = (1, 1, 1)
    costvolume_unet_attn_res: Sequence[int] = (4,)
    depth_unet_feat_dim: int = 32
    depth_unet_attn_res: Sequence[int] = (16,)
    depth_unet_channel_mult: Sequence[int] = (1, 1, 1, 1, 1)
    dav2_encoder: str = "vitb"
    dav2_input_size: int = 252
    gaussian_adapter: GaussianAdapterCfg = field(default_factory=GaussianAdapterCfg)
    opacity_mapping: OpacityMappingCfg = field(default_factory=OpacityMappingCfg)
    # Accepted for config compatibility with the JAX package, where it picks
    # a space-to-depth U-Net with the same function and parameters; the port
    # has one U-Net path and ignores it.
    s2d_unet: bool = False


def map_pdf_to_opacity(pdf: torch.Tensor, cfg: OpacityMappingCfg, global_step: int = 0) -> torch.Tensor:
    """Warm-up-scheduled opacity curve."""
    x = cfg.initial + min(global_step / cfg.warm_up, 1.0) * (cfg.final - cfg.initial)
    exponent = 2.0**x
    return 0.5 * (1.0 - (1.0 - pdf) ** exponent + pdf ** (1.0 / exponent))


class EncoderTranSplat(nn.Module):
    def __init__(self, cfg: EncoderCfg = EncoderCfg(), device="cuda"):
        super().__init__()
        if cfg.num_surfaces != 1:
            raise NotImplementedError("num_surfaces > 1 is not implemented")
        self.cfg = cfg
        adapter = cfg.gaussian_adapter
        self.backbone = BackboneMultiview(cfg.d_feature)
        self.da_model = DepthAnythingV2(cfg.dav2_encoder)
        self.depth_predictor = DepthPredictor(
            feature_channels=cfg.d_feature,
            upscale_factor=cfg.downscale_factor,
            num_depth_candidates=cfg.num_depth_candidates,
            costvolume_unet_feat_dim=cfg.costvolume_unet_feat_dim,
            costvolume_unet_channel_mult=cfg.costvolume_unet_channel_mult,
            costvolume_unet_attn_res=cfg.costvolume_unet_attn_res,
            gaussian_raw_channels=cfg.num_surfaces * (adapter.d_in + 2),
            gaussians_per_pixel=cfg.gaussians_per_pixel,
            num_views=cfg.num_context_views,
            depth_unet_feat_dim=cfg.depth_unet_feat_dim,
            depth_unet_attn_res=cfg.depth_unet_attn_res,
            depth_unet_channel_mult=cfg.depth_unet_channel_mult,
            dino_channels=DAV2_CONFIGS[cfg.dav2_encoder]["features"] // 2,
        )
        self.da_model.requires_grad_(False)
        self.to(device)
        self.eval()

    def forward(
        self,
        images: torch.Tensor,  # (b, v, H, W, 3) in [0, 1]
        intrinsics: torch.Tensor,  # (b, v, 3, 3) normalized
        extrinsics: torch.Tensor,  # (b, v, 4, 4) camera-to-world
        near: torch.Tensor,  # (b, v)
        far: torch.Tensor,  # (b, v)
        global_step: int = 0,  # position in the opacity warm-up
        generator: torch.Generator | None = None,  # dropout masks (training mode)
        deterministic_kernels: bool = False,  # the samplers' backward kernels repeat their bits
    ) -> Gaussians:
        cfg = self.cfg
        b, v, h, w, _ = images.shape

        # 1. Backbone on full-resolution img->world matrices.
        img2world = img2world_matrices(unnormalize_intrinsics(intrinsics, (h, w)), extrinsics)
        trans_features, cnn_features = self.backbone(images, img2world, attn_splits=cfg.multiview_trans_attn_split)

        # 2. Frozen DAv2 prior: normalized, channels shuffled [2, 0, 1], resized
        #    (align corners) to the DAv2 input size and back, min-max per view.
        da_in = normalize_images(images)[..., [2, 0, 1]]
        size = cfg.dav2_input_size
        da_in = resize_bilinear(da_in.reshape(b * v, h, w, 3), (size, size), align_corners=True)
        with torch.no_grad():
            da_depth, dino_feature = self.da_model(da_in)
        da_depth = resize_bilinear(da_depth[..., None], (h, w), align_corners=True)
        flat = da_depth.reshape(b * v, -1)
        lo = flat.min(dim=-1, keepdim=True).values
        hi = flat.max(dim=-1, keepdim=True).values
        da_depth = ((flat - lo) / (hi - lo + 1e-8)).reshape(b, v, h, w, 1)
        dino_feature = dino_feature.reshape(b, v, *dino_feature.shape[1:])

        # 3. Depth predictor.
        depths, densities, raw_gaussians, _ = self.depth_predictor(
            trans_features, cnn_features, images, intrinsics, extrinsics, near, far, da_depth, dino_feature,
            generator=generator, deterministic_kernels=deterministic_kernels,
        )

        # 4. Gaussian adapter: rays + depths -> world Gaussians.
        r = h * w
        xy, _ = sample_image_grid((h, w), device=images.device)
        xy = xy.reshape(1, 1, r, 2)
        raw = raw_gaussians.reshape(b, v, r, cfg.num_surfaces, -1)[:, :, :, 0, :]
        offset_xy = torch.sigmoid(raw[..., :2])
        pixel_size = torch.tensor([1.0 / w, 1.0 / h], dtype=raw.dtype, device=raw.device)
        coords = xy + (offset_xy - 0.5) * pixel_size
        opacities = map_pdf_to_opacity(densities[..., 0, 0], cfg.opacity_mapping, global_step) / cfg.gaussians_per_pixel
        adapter = cfg.gaussian_adapter
        out = adapt_gaussians(
            adapter, extrinsics, intrinsics, coords, depths[..., 0, 0], opacities, raw[..., 2:], (h, w)
        )
        return Gaussians(
            means=out["means"].reshape(b, v * r, 3),
            covariances=out["covariances"].reshape(b, v * r, 3, 3),
            harmonics=out["harmonics"].reshape(b, v * r, 3, adapter.d_sh),
            opacities=out["opacities"].reshape(b, v * r),
        )
