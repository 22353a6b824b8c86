"""EncoderTranSplat: posed context images -> per-pixel world Gaussians.

Counterpart of transplat_tpu/model/encoder.py: backbone (CNN + multi-view
Swin) -> frozen DAv2 mono prior -> depth predictor (epipolar deformable cost
volume) -> Gaussian adapter. The module starts in eval mode (BatchNorm
running statistics, no dropout) and honours train(): batch statistics, and
dropout masks from the generator given to forward. DAv2 is frozen: its
parameters take no gradient and it runs under no_grad.

forward runs the encoder as the ten stages of the reference's taxonomy
(`STAGES`, encoder_1 ... encoder_5), each inside a span of its name
(utils/trace.py); a caller may also wrap each one in a context of its own
(`stage`), which is how evaluation/staged.py times them.

Stage 5, the Gaussian adapter, is one launch of csrc/gaussian_adapter.cu
where its inputs are float32 on the card and no gradient is recorded
(serving, evaluation, the stage tools), and its plain PyTorch version
otherwise (training, the CPU); `counters()["adapter.fused"]` and
`["adapter.plain"]` count the two (utils/trace.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch
from torch import nn

from .. import kernels
from ..geometry.projection import sample_image_grid, unnormalize_intrinsics
from ..ops.interpolate import resize_bilinear
from ..utils.trace import count
from .adapter import GaussianAdapterCfg, adapt_gaussians, adapt_gaussians_fused
from .backbone.multiview import BackboneMultiview, normalize_images
from .dav2 import DAV2_CONFIGS, DepthAnythingV2
from .depth_predictor import DepthPredictor, img2world_matrices, stage_span
from .types import Gaussians


STAGES = [
    "encoder_1_prep_intrinsics",
    "encoder_2_backbone",
    "encoder_3_depth_anything",
    "encoder_4a_prep_features",
    "encoder_4b_cost_volume_matching",
    "encoder_4c_cost_volume_unet",
    "encoder_4d_coarse_depth",
    "encoder_4e_depth_refine_unet",
    "encoder_4f_gaussian_head",
    "encoder_5_gaussian_adapter",
]


COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


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
    # "float32" or "bfloat16": mixed-precision compute of the depth
    # predictor's convolutions, norms, U-Nets and heads (stages 4c-4f), with
    # float32 parameters; every softmax, the disparity expectation and the
    # disparity / density head stay float32 (model/depth_predictor.py). The
    # training loss's LPIPS runs its convolutions at this dtype too.
    compute_dtype: str = "float32"
    # Gradient checkpointing: recompute both U-Nets / each UV fine layer in
    # the backward instead of keeping their activations.
    remat_unet: bool = False
    remat_matching: bool = False
    # Accepted for config compatibility with the JAX package, where it picks
    # a space-to-depth U-Net with the same function and parameters; the port
    # has one U-Net path and ignores it. The JAX package refuses it with
    # bfloat16, and so does the port, so that one config means the same in both.
    s2d_unet: bool = False

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: expected one of {sorted(COMPUTE_DTYPES)}")
        if self.s2d_unet and self.compute_dtype == "bfloat16":
            raise ValueError(
                "s2d_unet=True requires compute_dtype='float32': the JAX package's s2d U-Net tower only builds "
                "when its dtype is None, so bf16 would silently disable it. Pick one."
            )

    @property
    def torch_dtype(self) -> torch.dtype | None:
        """The modules' compute dtype: None (float32) or torch.bfloat16."""
        return COMPUTE_DTYPES[self.compute_dtype]


def opacity_exponent(cfg: OpacityMappingCfg, global_step: int = 0) -> float:
    """The opacity curve's exponent at `global_step` of its warm-up."""
    x = cfg.initial + min(global_step / cfg.warm_up, 1.0) * (cfg.final - cfg.initial)
    return 2.0**x


def map_pdf_to_opacity(pdf: torch.Tensor, cfg: OpacityMappingCfg, global_step: int = 0) -> torch.Tensor:
    """Warm-up-scheduled opacity curve."""
    exponent = opacity_exponent(cfg, global_step)
    return 0.5 * (1.0 - (1.0 - pdf) ** exponent + pdf ** (1.0 / exponent))


def adapt_stage(
    cfg: EncoderCfg,
    extrinsics: torch.Tensor,  # (b, v, 4, 4)
    intrinsics: torch.Tensor,  # (b, v, 3, 3) normalized
    raw: torch.Tensor,  # (b, v, r, 2 + d_in): the pixel offsets, then adapt_gaussians' channels
    depth: torch.Tensor,  # (b, v, r, s): s Gaussians a pixel
    density: torch.Tensor,  # (b, v, r, s)
    global_step: int,
    image_shape: tuple[int, int],
    with_aux: bool = False,
) -> dict:
    """Stage 5: the Gaussians' fields (b, v*r*s, ...) in (view, pixel,
    sample) order, and with `with_aux` their scales and rotations. The s
    Gaussians of a pixel share its raw channels (offset, scales' logits,
    rotation, SH) and take their own depth and density; every opacity is
    divided by `cfg.gaussians_per_pixel`. One kernel launch where every
    input is float32 on the card and no gradient is recorded, the plain
    version otherwise; counted as `adapter.fused` / `adapter.plain`."""
    if kernels.kernel_route(raw, depth, density, intrinsics, extrinsics):
        count("adapter.fused", 1)
        return adapt_gaussians_fused(
            cfg.gaussian_adapter, extrinsics.contiguous(), intrinsics.contiguous(), raw, depth.contiguous(),
            density.contiguous(), opacity_exponent(cfg.opacity_mapping, global_step), cfg.gaussians_per_pixel,
            image_shape, with_aux=with_aux,
        )
    count("adapter.plain", 1)
    return adapt_stage_plain(cfg, extrinsics, intrinsics, raw, depth, density, global_step, image_shape, with_aux)


def adapt_stage_plain(
    cfg: EncoderCfg, extrinsics, intrinsics, raw, depth, density, global_step, image_shape, with_aux: bool = False
) -> dict:
    """Stage 5 in plain PyTorch: the pixel grid plus the predicted offsets,
    the opacity curve, `adapt_gaussians` over every (pixel, sample); the
    outputs of `adapt_stage`."""
    (h, w), (b, v, r, s) = image_shape, depth.shape
    xy, _ = sample_image_grid((h, w), device=raw.device)
    xy = xy.reshape(1, 1, r, 1, 2)
    offset_xy = torch.sigmoid(raw[..., None, :2])
    pixel_size = torch.tensor([1.0 / w, 1.0 / h], dtype=raw.dtype, device=raw.device)
    coords = (xy + (offset_xy - 0.5) * pixel_size).expand(b, v, r, s, 2).reshape(b, v, r * s, 2)
    channels = raw[..., None, 2:].expand(b, v, r, s, raw.shape[-1] - 2).reshape(b, v, r * s, -1)
    opacities = map_pdf_to_opacity(density, cfg.opacity_mapping, global_step) / cfg.gaussians_per_pixel
    adapter = cfg.gaussian_adapter
    out = adapt_gaussians(adapter, extrinsics, intrinsics, coords, depth.reshape(b, v, r * s),
                          opacities.reshape(b, v, r * s), channels, (h, w))
    fields = {"means": (3,), "covariances": (3, 3), "harmonics": (3, adapter.d_sh), "opacities": ()}
    if with_aux:
        fields.update(scales=(3,), rotations=(4,))
    return {k: out[k].reshape(b, v * r * s, *shape) for k, shape in fields.items()}


class EncoderTranSplat(nn.Module):
    stages = STAGES

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
            dtype=cfg.torch_dtype,
            remat_unet=cfg.remat_unet,
            remat_matching=cfg.remat_matching,
        )
        self.da_model.requires_grad_(False)
        self.to(device)
        self.eval()

    def dav2_inputs(self, images: torch.Tensor) -> torch.Tensor:
        """DAv2's input (b*v, S, S, 3): the images normalized, channels
        shuffled [2, 0, 1], resized (align corners) to the DAv2 input size."""
        b, v, h, w, _ = images.shape
        da_in = normalize_images(images)[..., [2, 0, 1]]
        size = self.cfg.dav2_input_size
        return resize_bilinear(da_in.reshape(b * v, h, w, 3), (size, size), align_corners=True)

    @staticmethod
    def mono_prior(da_depth: torch.Tensor, dino_feature: torch.Tensor, image_shape) -> tuple[torch.Tensor, torch.Tensor]:
        """DAv2's outputs as the depth predictor takes them: the depth resized
        (align corners) to the images' (b, v, H, W, 1), min-max per view; the
        features (b, v, hd, wd, cd)."""
        b, v, h, w = image_shape[:4]
        da_depth = resize_bilinear(da_depth[..., None], (h, w), align_corners=True)
        flat = da_depth.reshape(b * v, -1)
        lo = flat.min(dim=-1, keepdim=True).values
        hi = flat.max(dim=-1, keepdim=True).values
        da_depth = ((flat - lo) / (hi - lo + 1e-8)).reshape(b, v, h, w, 1)
        return da_depth, dino_feature.reshape(b, v, *dino_feature.shape[1:])

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
        return_aux: bool = False,
        stage=None,  # optional tag -> context manager entered inside each stage's span
    ):
        """Gaussians; with `return_aux`, (Gaussians, aux) where aux holds the
        depth predictor's `pdf` (b, v, hf, wf, D), `coarse_disps` and
        `depth_candidates` (b, v, D), and `depths` (b, v, H, W), `scales`
        (b, v*H*W, 3), `rotations` (b, v*H*W, 4, xyzw) and the backbone's
        matching `features` (b, v, hf, wf, C), NHWC as the JAX encoder lays
        them out."""
        cfg = self.cfg
        b, v, h, w, _ = images.shape

        # 1. Full-resolution img->world matrices for the backbone.
        with stage_span("encoder_1_prep_intrinsics", stage):
            img2world = img2world_matrices(unnormalize_intrinsics(intrinsics, (h, w)), extrinsics)
        with stage_span("encoder_2_backbone", stage):
            trans_features, cnn_features = self.backbone(images, img2world, attn_splits=cfg.multiview_trans_attn_split)

        # 2. Frozen DAv2 prior.
        with stage_span("encoder_3_depth_anything", stage):
            with torch.no_grad():
                da_depth, dino_feature = self.da_model(self.dav2_inputs(images))
            da_depth, dino_feature = self.mono_prior(da_depth, dino_feature, images.shape)

        # 3. Depth predictor (stages 4a-4f).
        depths, densities, raw_gaussians, aux = self.depth_predictor(
            trans_features, cnn_features, images, intrinsics, extrinsics, near, far, da_depth, dino_feature,
            generator=generator, deterministic_kernels=deterministic_kernels, stage=stage,
        )

        # 4. Gaussian adapter: rays + depths -> world Gaussians.
        with stage_span("encoder_5_gaussian_adapter", stage):
            raw = raw_gaussians.reshape(b, v, h * w, cfg.num_surfaces, -1)[:, :, :, 0, :]
            out = adapt_stage(
                cfg, extrinsics, intrinsics, raw, depths[..., 0, :1], densities[..., 0, :1], global_step, (h, w),
                with_aux=return_aux,
            )
            gaussians = Gaussians(out["means"], out["covariances"], out["harmonics"], out["opacities"])
        if not return_aux:
            return gaussians
        aux = {
            **aux,
            "depths": depths.reshape(b, v, h, w),
            "scales": out["scales"],
            "rotations": out["rotations"],
            "features": trans_features,
        }
        return gaussians, aux
