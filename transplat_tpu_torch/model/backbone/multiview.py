"""Multi-view matching backbone: CNN -> camera SE modulation -> windowed
positional encoding -> cross-view Swin transformer (counterpart of
transplat_tpu/model/backbone/multiview.py)."""

from __future__ import annotations

import torch
from torch import nn

from ...utils.constants import device_constant
from ..cam_encoder import CamParamEncoder
from ..layers import to_nchw, to_nhwc
from .cnn import CNNEncoder
from .position import add_position_windowed
from .transformer import MultiViewFeatureTransformer

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize (..., H, W, 3) images in [0, 1]."""
    return (images - device_constant(IMAGENET_MEAN, images)) / device_constant(IMAGENET_STD, images)


class BackboneMultiview(nn.Module):
    def __init__(self, feature_channels: int = 128, num_transformer_layers: int = 6, ffn_dim_expansion: int = 4):
        super().__init__()
        self.feature_channels = feature_channels
        self.backbone = CNNEncoder(feature_channels)
        self.cam_param_encoder = CamParamEncoder(feature_channels, 128, feature_channels)
        self.transformer = MultiViewFeatureTransformer(num_transformer_layers, feature_channels, ffn_dim_expansion)

    def forward(self, images: torch.Tensor, img2world: torch.Tensor, attn_splits: int = 2):
        """images (B, V, H, W, 3) in [0, 1]; img2world (B, V, 4, 4).

        Returns (trans_features, cnn_features), both (B, V, H/4, W/4, C)."""
        b, v, h, w, _ = images.shape
        c = self.feature_channels
        x = to_nchw(normalize_images(images).reshape(b * v, h, w, 3))
        cnn = self.backbone(x)  # (BV, C, hf, wf)
        hf, wf = cnn.shape[-2:]
        cnn_features = to_nhwc(cnn).reshape(b, v, hf, wf, c)
        feats = to_nhwc(self.cam_param_encoder(cnn, img2world.reshape(b * v, 16)))
        feats = add_position_windowed(feats, attn_splits, c).reshape(b, v, hf, wf, c)
        return self.transformer(feats, splits=attn_splits), cnn_features
