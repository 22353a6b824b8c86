"""Camera-parameter SE encoder.

Counterpart of transplat_tpu/model/cam_encoder.py: flattened 4x4 img->world
matrix (16 floats) -> BN -> MLP -> SE gate over conv-reduced features. In
training mode the two BatchNorms use batch statistics and update their
running ones as flax.linen.BatchNorm(momentum=0.9) does (layers.py).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .layers import BatchNorm1d, BatchNorm2d, Mlp, SELayer, conv


class CamParamEncoder(nn.Module):
    def __init__(self, in_channels: int, mid_channels: int = 128, embed_dims: int = 128):
        super().__init__()
        self.bn = BatchNorm1d(16, eps=1e-5, momentum=0.1)
        self.reduce_conv_0 = conv(in_channels, mid_channels, 3)
        self.reduce_bn = BatchNorm2d(mid_channels, eps=1e-5, momentum=0.1)
        self.context_mlp = Mlp(16, mid_channels, mid_channels)
        self.context_se = SELayer(mid_channels)
        self.context_conv = conv(mid_channels, embed_dims, 1)

    def forward(self, feat: torch.Tensor, cam_params: torch.Tensor) -> torch.Tensor:
        """feat (N, C_in, H, W), cam_params (N, 16) -> (N, embed_dims, H, W)."""
        mlp_input = self.bn(cam_params)
        x = F.relu(self.reduce_bn(self.reduce_conv_0(feat)))
        se = self.context_mlp(mlp_input)
        x = self.context_se(x, se[:, :, None, None])
        return self.context_conv(x)
