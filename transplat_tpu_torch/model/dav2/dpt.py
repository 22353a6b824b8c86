"""DPT depth head + DepthAnythingV2 wrapper (frozen monocular prior).

Counterpart of transplat_tpu/model/dav2/dpt.py. Returns (depth, fusion
feature); the fusion feature (features // 2 channels at 4x patch
resolution) is the "dino_feature" prior of the depth predictor.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.interpolate import resize_bilinear_nchw
from ..layers import conv, to_nhwc

# Depth-Anything-V2's encoders: the ViT's width, blocks and heads, the blocks
# whose tokens the DPT head reads (its intermediate_layer_idx), and the head's
# widths.
DAV2_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6, layers=(2, 5, 8, 11), features=64,
                 out_channels=(48, 96, 192, 384)),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12, layers=(2, 5, 8, 11), features=128,
                 out_channels=(96, 192, 384, 768)),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16, layers=(4, 11, 17, 23), features=256,
                 out_channels=(256, 512, 1024, 1024)),
}


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = conv(features, features, 3)
        self.conv2 = conv(features, features, 3)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, with_residual: bool):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features) if with_residual else None
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = conv(features, features, 1)

    def forward(self, x, res=None, out_size=None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        if out_size is None:
            out_size = (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out_conv(resize_bilinear_nchw(x, out_size, align_corners=True))


class DPTHead(nn.Module):
    def __init__(self, embed_dim: int, features: int = 128, out_channels=(96, 192, 384, 768)):
        super().__init__()
        oc = out_channels
        for i in range(4):
            self.add_module(f"project_{i}", conv(embed_dim, oc[i], 1))
        self.resize_0 = nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4)
        self.resize_1 = nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2)
        self.resize_3 = conv(oc[3], oc[3], 3, stride=2)
        for i in range(4):
            self.add_module(f"layer{i + 1}_rn", conv(oc[i], features, 3, bias=False))
        for i in range(1, 5):
            self.add_module(f"refinenet{i}", FeatureFusionBlock(features, with_residual=i != 4))
        self.output_conv1 = conv(features, features // 2, 3)
        self.output_conv2_0 = conv(features // 2, 32, 3)
        self.output_conv2_2 = conv(32, 1, 1)

    def forward(self, layer_tokens, patch_h: int, patch_w: int):
        """layer_tokens: 4 (B, N, C) token maps, shallow -> deep.
        Returns depth (B, 1, 14 ph, 14 pw) and feature (B, features/2, 4 ph, 4 pw)."""
        b = layer_tokens[0].shape[0]
        maps = []
        for i, tokens in enumerate(layer_tokens):
            x = tokens.transpose(1, 2).reshape(b, -1, patch_h, patch_w)
            x = getattr(self, f"project_{i}")(x)
            if i == 0:
                x = self.resize_0(x)
            elif i == 1:
                x = self.resize_1(x)
            elif i == 3:
                x = self.resize_3(x)
            maps.append(x)
        rn = [getattr(self, f"layer{i + 1}_rn")(m) for i, m in enumerate(maps)]
        path4 = self.refinenet4(rn[3], out_size=rn[2].shape[-2:])
        path3 = self.refinenet3(path4, rn[2], out_size=rn[1].shape[-2:])
        path2 = self.refinenet2(path3, rn[1], out_size=rn[0].shape[-2:])
        path1 = self.refinenet1(path2, rn[0])
        feat = self.output_conv1(path1)
        h = resize_bilinear_nchw(feat, (patch_h * 14, patch_w * 14), align_corners=True)
        h = self.output_conv2_2(F.relu(self.output_conv2_0(h)))
        return F.relu(h), feat


class DepthAnythingV2(nn.Module):
    """Frozen relative-depth prior. Input (B, H, W, 3) normalized, H, W % 14 == 0."""

    def __init__(self, encoder: str = "vitb"):
        super().__init__()
        from .vit import DinoVisionTransformer

        cfg = DAV2_CONFIGS[encoder]
        self.take_layers = cfg["layers"]
        self.pretrained = DinoVisionTransformer(embed_dim=cfg["embed_dim"], depth=cfg["depth"], num_heads=cfg["num_heads"])
        self.depth_head = DPTHead(cfg["embed_dim"], cfg["features"], cfg["out_channels"])

    def forward(self, x: torch.Tensor):
        """Returns depth (B, H, W) and feature (B, 4 ph, 4 pw, features/2), NHWC like JAX."""
        patch_h, patch_w = x.shape[1] // 14, x.shape[2] // 14
        tokens = self.pretrained(x, take_layers=self.take_layers)
        depth, feature = self.depth_head(tokens, patch_h, patch_w)
        return depth[:, 0], to_nhwc(feature)
