"""Depth predictor: epipolar cost volume by depth-aware deformable attention,
cost-volume U-Net, coarse-to-fine depth, and Gaussian heads.

Counterpart of transplat_tpu/model/depth_predictor.py (stages 4a-4f). The
JAX `nn.vmap` of UVMatcher over directed view pairs becomes a written-out
pair dim. Public tensors are NHWC like the JAX module; convolutions run NCHW.

`dtype` (the encoder's compute_dtype; None: float32) runs the convolutions,
norms and U-Nets of stages 4c-4f in it with float32 parameters; the cam
encoder and the UV matcher stay float32. The casts to float32 sit where the
JAX module has them (the pdf's softmax, the Gaussian head's input, the raw
Gaussians and the disparity head's output) or where its type promotion puts
them (the resize of the upsampler's output, the refine U-Net's input).
`remat_unet` / `remat_matching` checkpoint both U-Nets / each fine layer
of the matcher.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch import nn

from ..geometry.epipolar import epipolar_sample_grid, inverse_depth_candidates, relative_pose
from ..geometry.projection import unnormalize_intrinsics
from ..ops.interpolate import resize_bilinear_nchw, upsample_nearest_nchw
from ..utils.trace import span
from .cam_encoder import CamParamEncoder
from .layers import LN_EPS, GroupNorm, at_least_f32, conv, gelu, group_norm, to_nchw, to_nhwc
from .unet import UNetModel
from .uv_transformer import UVMatcher


def stage_span(tag: str, stage=None):
    """The span `tag` (utils/trace.py) around one of the encoder's stages and,
    inside it, the caller's own context `stage(tag)` where one is given."""
    if stage is None:
        return span(tag)
    return _span_and_stage(tag, stage)


@contextlib.contextmanager
def _span_and_stage(tag: str, stage):
    with span(tag), stage(tag):
        yield


def img2world_matrices(intrinsics_px: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    """extrinsics @ inv([[K, 0], [0, 1]]) for (b, v) pixel intrinsics. (`inv_ex`
    is `inv`'s kernel without its error check, which waits for the card.)"""
    camk = torch.eye(4, dtype=extrinsics.dtype, device=extrinsics.device).expand(*extrinsics.shape[:-2], 4, 4).clone()
    camk[..., :3, :3] = intrinsics_px
    return torch.matmul(extrinsics, torch.linalg.inv_ex(camk).inverse)


class DepthPredictor(nn.Module):
    def __init__(
        self,
        feature_channels: int = 128,
        upscale_factor: int = 4,
        num_depth_candidates: int = 128,
        costvolume_unet_feat_dim: int = 128,
        costvolume_unet_channel_mult: Sequence[int] = (1, 1, 1),
        costvolume_unet_attn_res: Sequence[int] = (4,),
        gaussian_raw_channels: int = 84,
        gaussians_per_pixel: int = 1,
        num_views: int = 2,
        depth_unet_feat_dim: int = 32,
        depth_unet_attn_res: Sequence[int] = (16,),
        depth_unet_channel_mult: Sequence[int] = (1, 1, 1, 1, 1),
        dino_channels: int = 64,
        dtype: torch.dtype | None = None,
        remat_unet: bool = False,
        remat_matching: bool = False,
    ):
        super().__init__()
        c, d = feature_channels, num_depth_candidates
        if d != c:
            raise ValueError("num_depth_candidates must equal feature_channels")
        cf, df = costvolume_unet_feat_dim, depth_unet_feat_dim
        self.num_depth_candidates = d
        self.upscale_factor = upscale_factor
        self.gaussians_per_pixel = gaussians_per_pixel
        self.num_views = num_views

        self.cam_param_encoder = CamParamEncoder(dino_channels, 128, c)
        self.uv_matcher = UVMatcher(c, d, remat=remat_matching)
        self.corr_conv_in = conv(2 * c, cf, 3, dtype=dtype)
        self.corr_norm_in = group_norm(cf, dtype)
        self.corr_unet = UNetModel(
            cf, cf, cf, 1, tuple(costvolume_unet_attn_res), tuple(costvolume_unet_channel_mult), num_frames=num_views,
            dtype=dtype, remat=remat_unet,
        )
        self.corr_conv_out = conv(cf, d, 3, dtype=dtype)
        self.regressor_residual = conv(2 * c, d, 1, dtype=dtype)
        self.depth_head_0 = conv(d, 2 * d, 3, dtype=dtype)
        self.depth_head_2 = conv(2 * d, d, 3, dtype=dtype)
        self.upsampler_conv = conv(2 * c, c, 3, dtype=dtype)
        self.proj_feature = conv(c, df, 3, dtype=dtype)
        self.refine_conv_in = conv(df + 6, df, 3, dtype=dtype)
        self.refine_norm_in = GroupNorm(4, df, eps=LN_EPS, compute_dtype=dtype)
        self.refine_unet = UNetModel(
            df, df, df, 1, tuple(depth_unet_attn_res), tuple(depth_unet_channel_mult), num_frames=num_views,
            dtype=dtype, remat=remat_unet,
        )
        self.to_gaussians_0 = conv(df + 3 + c, gaussian_raw_channels * 2, 3, dtype=dtype)
        self.to_gaussians_2 = conv(gaussian_raw_channels * 2, gaussian_raw_channels, 3, dtype=dtype)
        self.to_disparity_0 = conv(df, df * 2, 3, dtype=dtype)
        self.to_disparity_2 = conv(df * 2, gaussians_per_pixel * 2, 3, dtype=dtype)

    def prep(self, features, intrinsics, extrinsics, near, far, dino_feature):
        """Per-view geometry + directed-pair tensors (encoder_4a)."""
        b, v, hf, wf, c = features.shape
        d = self.num_depth_candidates
        q = hf * wf
        intr_px = unnormalize_intrinsics(intrinsics, (hf, wf))
        disp_candidates = inverse_depth_candidates(near, far, d)  # (b, v, D)
        dino = to_nchw(dino_feature.reshape(b * v, *dino_feature.shape[2:]))
        dino_small = resize_bilinear_nchw(dino, (hf, wf), True)
        bev_pos = self.cam_param_encoder(dino_small, img2world_matrices(intr_px, extrinsics).reshape(b * v, 16))
        bev_pos = to_nhwc(bev_pos).reshape(b, v, q, c)

        pairs = [(i, j) for i in range(v) for j in range(v) if j != i]
        feats_tok = features.reshape(b, v, q, c)
        grids = []
        with torch.no_grad():  # the sampling grid is a constant of the gradient, as in the JAX package
            for i, j in pairs:
                g = epipolar_sample_grid(
                    intr_px[:, i], relative_pose(extrinsics[:, i], extrinsics[:, j]),
                    1.0 / disp_candidates[:, i], hf, wf,
                )  # (b, D, HW, 2)
                grids.append(g.transpose(1, 2))  # (b, Q, D, 2)
        n = b * len(pairs)
        ry = (torch.arange(hf, dtype=features.dtype, device=features.device) + 0.5) / hf
        rx = (torch.arange(wf, dtype=features.dtype, device=features.device) + 0.5) / wf
        yy, xx = torch.meshgrid(ry, rx, indexing="ij")
        ref2d = torch.stack([xx, yy], dim=-1).reshape(q, 2)
        return {
            "grid": torch.stack(grids, 1).reshape(n, q, d, 2),
            "key": torch.stack([feats_tok[:, i] for i, _ in pairs], 1).reshape(n, q, c),
            "value": torch.stack([feats_tok[:, j] for _, j in pairs], 1).reshape(n, q, c),
            "pos": torch.stack([bev_pos[:, i] for i, _ in pairs], 1).reshape(n, q, c),
            "ref2d": ref2d.expand(n, q, 2),
            "disp_candidates": disp_candidates,
        }

    def matching(self, prep, hw: tuple[int, int], generator=None, deterministic_kernels: bool = False):
        """Directed-pair UV matching -> per-view correlation (b, v, Q, C) (encoder_4b)."""
        corr = self.uv_matcher(
            prep["key"], prep["value"], prep["pos"], prep["grid"], prep["ref2d"], hw, generator, deterministic_kernels
        )
        v = self.num_views
        b = corr.shape[0] // (v * (v - 1))
        return corr.reshape(b, v, v - 1, hw[0] * hw[1], corr.shape[-1]).mean(dim=2)

    def cost_unet(self, corr, features):
        """U-Net refinement + residual skip (encoder_4c). Returns NCHW (bv, D, hf, wf)."""
        b, v, hf, wf, c = features.shape
        raw_in = torch.cat(
            [to_nchw(corr.reshape(b * v, hf, wf, c)), to_nchw(features.reshape(b * v, hf, wf, c))], dim=1
        )
        h = gelu(self.corr_norm_in(self.corr_conv_in(raw_in)))
        return self.corr_conv_out(self.corr_unet(h)) + self.regressor_residual(raw_in)

    def coarse_depth(self, raw_corr, disp_candidates, image_shape):
        """Softmax-expectation coarse disparity + upsampling (encoder_4d), NCHW."""
        d = self.num_depth_candidates
        bv = raw_corr.shape[0]
        logits = self.depth_head_2(gelu(self.depth_head_0(raw_corr)))
        pdf = torch.softmax(at_least_f32(logits), dim=1)  # (bv, D, hf, wf), float32 whatever the compute dtype
        coarse_disps = torch.sum(disp_candidates.reshape(bv, d, 1, 1) * pdf, dim=1, keepdim=True)
        pdf_max = torch.max(pdf, dim=1, keepdim=True).values
        return {
            "pdf": pdf,
            "coarse_disps": coarse_disps,
            "pdf_max_full": upsample_nearest_nchw(pdf_max, self.upscale_factor),
            "fullres_disps": resize_bilinear_nchw(coarse_disps, image_shape, align_corners=True),
        }

    def refine(self, features, cnn_features, images, da_depth, coarse):
        """Upsampler + refine U-Net at full resolution (encoder_4e), NCHW."""
        b, v, hf, wf, c = features.shape
        big_h, big_w = images.shape[2:4]
        proj_in = torch.cat(
            [to_nchw(features.reshape(b * v, hf, wf, c)), to_nchw(cnn_features.reshape(b * v, hf, wf, c))], dim=1
        )
        # JAX resizes with float32 matrices: the product is float32 whatever the conv's dtype.
        up = resize_bilinear_nchw(at_least_f32(self.upsampler_conv(proj_in)), (big_h, big_w), align_corners=True)
        proj_feat_fullres = gelu(up)
        refine_in = torch.cat(  # float32, as JAX's concatenation promotes it
            [
                to_nchw(images.reshape(b * v, big_h, big_w, 3)),
                to_nchw(da_depth.reshape(b * v, big_h, big_w, 1)),
                self.proj_feature(proj_feat_fullres).to(images.dtype),
                coarse["fullres_disps"],
                coarse["pdf_max_full"],
            ],
            dim=1,
        )
        h = gelu(self.refine_norm_in(self.refine_conv_in(refine_in)))
        return self.refine_unet(h), proj_feat_fullres

    def heads(self, refine_out, proj_feat_fullres, images, fullres_disps, near, far):
        """Raw Gaussians + fine disparity/density heads (encoder_4f)."""
        b, v, big_h, big_w = images.shape[:4]
        imgs = to_nchw(images.reshape(b * v, big_h, big_w, 3))
        gau_in = torch.cat([refine_out.to(imgs.dtype), imgs, proj_feat_fullres.to(imgs.dtype)], dim=1)
        raw = at_least_f32(self.to_gaussians_2(gelu(self.to_gaussians_0(gau_in))))
        raw_gaussians = to_nhwc(raw).reshape(b, v, big_h * big_w, -1)
        # The disparity deltas and densities in float32: depth = 1 / disparity amplifies rounding.
        dd = at_least_f32(self.to_disparity_2(gelu(self.to_disparity_0(refine_out))))
        gpp = self.gaussians_per_pixel
        delta_disps, raw_densities = dd[:, :gpp], dd[:, gpp:]
        densities = to_nhwc(torch.sigmoid(raw_densities)).reshape(b, v, big_h * big_w, 1, gpp)
        lo = (1.0 / far).reshape(b * v, 1, 1, 1)
        hi = (1.0 / near).reshape(b * v, 1, 1, 1)
        fine_disps = torch.minimum(torch.maximum(fullres_disps + delta_disps, lo), hi)
        depths = (1.0 / to_nhwc(fine_disps)).reshape(b, v, big_h * big_w, 1, gpp)
        return depths, densities, raw_gaussians

    def forward(
        self, features, cnn_features, images, intrinsics, extrinsics, near, far, da_depth, dino_feature,
        generator=None,
        deterministic_kernels: bool = False,
        stage=None,
    ):
        """features/cnn_features (b, v, hf, wf, C); images (b, v, H, W, 3);
        da_depth (b, v, H, W, 1); dino_feature (b, v, hd, wd, cd); generator:
        the dropout masks' source in training mode; deterministic_kernels:
        the samplers' backward kernels repeat their bits; stage: an optional
        tag -> context manager entered inside each span of the stages 4a-4f.
        Returns depths, densities (b, v, H*W, 1, gpp), raw_gaussians (b, v, H*W, raw), aux."""
        b, v, hf, wf, _ = features.shape
        big_h, big_w = images.shape[2:4]
        with stage_span("encoder_4a_prep_features", stage):
            prep = self.prep(features, intrinsics, extrinsics, near, far, dino_feature)
        with stage_span("encoder_4b_cost_volume_matching", stage):
            corr = self.matching(prep, (hf, wf), generator, deterministic_kernels)
        with stage_span("encoder_4c_cost_volume_unet", stage):
            raw_corr = self.cost_unet(corr, features)
        with stage_span("encoder_4d_coarse_depth", stage):
            coarse = self.coarse_depth(raw_corr, prep["disp_candidates"], (big_h, big_w))
        with stage_span("encoder_4e_depth_refine_unet", stage):
            refine_out, proj_feat_fullres = self.refine(features, cnn_features, images, da_depth, coarse)
        with stage_span("encoder_4f_gaussian_head", stage):
            depths, densities, raw_gaussians = self.heads(
                refine_out, proj_feat_fullres, images, coarse["fullres_disps"], near, far
            )
        aux = {
            "pdf": to_nhwc(coarse["pdf"]).reshape(b, v, hf, wf, self.num_depth_candidates),
            "coarse_disps": coarse["coarse_disps"].reshape(b, v, hf, wf),
            "depth_candidates": 1.0 / prep["disp_candidates"],
        }
        return depths, densities, raw_gaussians, aux
