"""Shared building blocks.

Counterpart of transplat_tpu/model/layers.py. Convolutions run NCHW; module
and attribute names follow the Flax modules so weights map mechanically
(convert.load_jax_variables). Norm epsilons are the Flax ones: LayerNorm
and a plain GroupNorm 1e-6, the U-Net `group_norm` 1e-5, BatchNorm 1e-5.

Modules honour train() / eval(). Dropout masks are drawn from a
`torch.Generator` the caller hands down, never from the global RNG.
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


class Dropout(nn.Module):
    """Inverted dropout (flax.linen.Dropout): in training each value is kept
    with probability 1 - rate and scaled by 1 / (1 - rate); the mask is drawn
    from `generator` (on the tensor's device). Identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} not in [0, 1)")
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training mode needs a torch.Generator")
        keep = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) >= self.rate
        return x * keep / (1.0 - self.rate)


class _FlaxBatchNorm:
    """Training-mode forward of flax.linen.BatchNorm(momentum=0.9), which is
    PyTorch's momentum 0.1: normalise with the batch's mean and biased
    variance and move the running statistics a tenth of the way to them.
    (PyTorch's own update feeds the unbiased variance to the running one;
    Flax feeds the biased one, and the port follows Flax.)"""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0, *range(2, x.ndim)]
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, unbiased=False)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class Mlp(nn.Module):
    """2-layer ReLU MLP."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(cin, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class FFN(nn.Module):
    """Residual feed-forward with dropout after the activation and after fc2."""

    def __init__(self, embed_dims: int = 128, feedforward: int = 256, dropout: float = 0.1):
        super().__init__()
        self.fc1 = nn.Linear(embed_dims, feedforward)
        self.fc2 = nn.Linear(feedforward, embed_dims)
        self.dropout = Dropout(dropout)

    def forward(self, x, generator: torch.Generator | None = None):
        h = self.dropout(F.relu(self.fc1(x)), generator)
        return x + self.dropout(self.fc2(h), generator)


class SELayer(nn.Module):
    """Squeeze-excite gate: x (N, C, H, W) * sigmoid(MLP(x_se (N, C, 1, 1)))."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = conv(channels, channels, 1)
        self.conv_expand = conv(channels, channels, 1)

    def forward(self, x, x_se):
        return x * torch.sigmoid(self.conv_expand(F.relu(self.conv_reduce(x_se))))
