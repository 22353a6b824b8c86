"""VGG16 features and the LPIPS distance, frozen from the port's loss/vgg.py:
five convolution stages tapped after relu1_2 / relu2_2 / relu3_3 / relu4_3 /
relu5_3, unit-normalised over channels, non-negative 1x1 heads, spatial
mean. The module draws no weights of its own: they are handed in.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..model.layers import Conv2d, at_least_f32

# VGG16 conv plan: (channels, number of convs) per stage.
_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

# The lpips input normalisation (its "scaling layer").
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        cin, idx = 3, 0
        for ch, n_convs in _STAGES:
            for _ in range(n_convs):
                self.add_module(f"conv{idx}", Conv2d(cin, ch, 3, padding=1))
                cin = ch
                idx += 1

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> list[torch.Tensor]:
        """x (N, H, W, 3) in [-1, 1] -> the 5 taps, each (N, C, h, w), the
        convolutions computed in `dtype` (None: float32)."""
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        h = ((x - shift) / scale).permute(0, 3, 1, 2)
        taps, idx = [], 0
        for stage, (_, n_convs) in enumerate(_STAGES):
            for _ in range(n_convs):
                h = F.relu(getattr(self, f"conv{idx}").at(h, dtype))
                idx += 1
            taps.append(h)
            if stage != len(_STAGES) - 1:
                h = F.max_pool2d(h, 2, 2)
        return taps


class LPIPS(nn.Module):
    """Learned perceptual distance: forward(a, b) -> (N,) distances."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(_STAGES):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.empty(ch)))
        self.requires_grad_(False)  # frozen: a fixed part of the loss

    def forward(self, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """a, b (N, H, W, 3) in [0, 1]; `dtype`: the VGG convolutions' compute
        dtype (None: float32); the scores are float32."""
        fa = self.vgg(2.0 * a - 1.0, dtype)
        fb = self.vgg(2.0 * b - 1.0, dtype)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            xa, xb = at_least_f32(xa), at_least_f32(xb)
            na = xa / (torch.linalg.norm(xa, dim=1, keepdim=True) + 1e-10)
            nb = xb / (torch.linalg.norm(xb, dim=1, keepdim=True) + 1e-10)
            diff = (na - nb) ** 2
            head = getattr(self, f"lin{i}").abs()
            total = total + torch.mean(torch.sum(diff * head[None, :, None, None], dim=1), dim=(-2, -1))
        return total
