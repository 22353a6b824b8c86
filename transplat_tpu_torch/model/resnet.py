"""ResNet-50 in torchvision's layout, for pixelSplat's backbone
(model/encoder_epipolar.py): Bottleneck blocks with the stride on the 3 x 3
convolution, BatchNorm with running statistics in eval mode, and the names
of torchvision's state dict (conv1, bn1, layer1.0.conv1, ...,
layer2.0.downsample.0), so that a torchvision checkpoint's tensors map by
name. pixelSplat reads the stem and layers 1-3 and leaves out the max-pool,
so this network has no max-pool, no layer4 and no classifier. torchvision
itself is not a dependency.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False), nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """The stem and layers 1-3 of ResNet-50 (3, 4 and 6 Bottleneck blocks of
    widths 64, 128, 256; 256, 512 and 1024 channels out)."""

    LAYERS = ((64, 3, 1), (128, 4, 2), (256, 6, 2))

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i, (width, blocks, stride) in enumerate(self.LAYERS):
            layer = []
            for j in range(blocks):
                layer.append(Bottleneck(cin, width, stride if j == 0 else 1))
                cin = width * Bottleneck.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*layer))

    @property
    def channels(self) -> tuple[int, ...]:
        """Channels of `forward`'s four features."""
        return (64,) + tuple(w * Bottleneck.expansion for w, _, _ in self.LAYERS)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x (N, 3, H, W) -> [relu(bn1(conv1 x)) at H/2, layer1 at H/2, layer2
        at H/4, layer3 at H/8] (no max-pool after the stem)."""
        x = F.relu(self.bn1(self.conv1(x)))
        features = [x]
        for i in range(len(self.LAYERS)):
            x = getattr(self, f"layer{i + 1}")(x)
            features.append(x)
        return features
