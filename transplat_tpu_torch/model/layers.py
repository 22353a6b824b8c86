"""Shared building blocks.

Counterpart of transplat_tpu/model/layers.py. Convolutions run NCHW; module
and attribute names follow the Flax modules so weights map mechanically
(convert.load_jax_variables). Norm epsilons are the Flax ones: LayerNorm
and a plain GroupNorm 1e-6, the U-Net `group_norm` 1e-5, BatchNorm 1e-5.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

LN_EPS = 1e-6  # flax.linen.LayerNorm / GroupNorm default


def conv(cin: int, cout: int, kernel: int = 3, stride: int = 1, bias: bool = True) -> nn.Conv2d:
    """Conv with torch "padding = (k - 1) // 2" semantics (the JAX `conv`)."""
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=bias)


def layer_norm(channels: int) -> nn.LayerNorm:
    return nn.LayerNorm(channels, eps=LN_EPS)


def group_norm(channels: int) -> nn.GroupNorm:
    """The LDM-UNet normalization: GN(8) if divisible else GN(4), eps 1e-5."""
    return nn.GroupNorm(8 if channels % 8 == 0 else 4, channels, eps=1e-5)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on (N, C, H, W)."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = x.var(dim=(-2, -1), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Mlp(nn.Module):
    """2-layer ReLU MLP."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(cin, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class FFN(nn.Module):
    """Residual feed-forward (dropout is inference-off)."""

    def __init__(self, embed_dims: int = 128, feedforward: int = 256):
        super().__init__()
        self.fc1 = nn.Linear(embed_dims, feedforward)
        self.fc2 = nn.Linear(feedforward, embed_dims)

    def forward(self, x):
        return x + self.fc2(F.relu(self.fc1(x)))


class SELayer(nn.Module):
    """Squeeze-excite gate: x (N, C, H, W) * sigmoid(MLP(x_se (N, C, 1, 1)))."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = conv(channels, channels, 1)
        self.conv_expand = conv(channels, channels, 1)

    def forward(self, x, x_se):
        return x * torch.sigmoid(self.conv_expand(F.relu(self.conv_reduce(x_se))))
