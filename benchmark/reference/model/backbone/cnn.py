"""UniMatch-style CNN feature encoder (1/4 resolution), counterpart of
transplat_tpu/model/backbone/cnn.py, NCHW."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..layers import conv, instance_norm


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, stride, bias=False)
        self.conv2 = conv(planes, planes, 3, 1, bias=False)
        self.downsample = conv(cin, planes, 1, stride) if stride != 1 or cin != planes else None

    def forward(self, x):
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class CNNEncoder(nn.Module):
    """(N, 3, H, W) -> (N, output_dim, H/4, W/4)."""

    def __init__(self, output_dim: int = 128):
        super().__init__()
        dims = (64, 96, 128)
        self.conv1 = conv(3, dims[0], 7, 2, bias=False)
        self.layer1_0 = ResidualBlock(dims[0], dims[0], 1)
        self.layer1_1 = ResidualBlock(dims[0], dims[0], 1)
        self.layer2_0 = ResidualBlock(dims[0], dims[1], 2)
        self.layer2_1 = ResidualBlock(dims[1], dims[1], 1)
        self.layer3_0 = ResidualBlock(dims[1], dims[2], 1)
        self.layer3_1 = ResidualBlock(dims[2], dims[2], 1)
        self.conv2 = conv(dims[2], output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(instance_norm(self.conv1(x)))
        for layer in (self.layer1_0, self.layer1_1, self.layer2_0, self.layer2_1, self.layer3_0, self.layer3_1):
            x = layer(x)
        return self.conv2(x)
