"""VGG16 feature extractor + LPIPS perceptual distance, float32.

Counterpart of transplat_tpu/loss/vgg.py (the lpips package's VGG variant):
five conv stages tapped after relu1_2 / relu2_2 / relu3_3 / relu4_3 /
relu5_3, unit-normalised over channels, non-negative 1x1 heads, spatial mean.
Plain convolutions, no hand-written kernel. Module and parameter names
follow the Flax modules (`vgg.conv{i}`, `lin{i}`), so
convert.load_jax_variables fills them from {"params": lpips_params}.

Calibrated LPIPS weights are not part of the repository: the module starts
from a random initialisation (same compute as calibrated weights, not a
calibrated perceptual metric).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

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
                self.add_module(f"conv{idx}", nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch
                idx += 1

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x (N, H, W, 3) in [-1, 1] -> the 5 taps, each (N, C, h, w)."""
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        h = ((x - shift) / scale).permute(0, 3, 1, 2)
        taps, idx = [], 0
        for stage, (_, n_convs) in enumerate(_STAGES):
            for _ in range(n_convs):
                h = F.relu(getattr(self, f"conv{idx}")(h))
                idx += 1
            taps.append(h)
            if stage != len(_STAGES) - 1:
                h = F.max_pool2d(h, 2, 2)
        return taps


class LPIPS(nn.Module):
    """Learned perceptual distance: forward(a, b) -> (N,) distances."""

    def __init__(self, device="cuda", seed: int = 0):
        """Random initialisation from `seed`: U(+-1/sqrt(fan_in)) convolutions,
        zero biases, heads U(0, 0.1) (the Flax initialiser's range)."""
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(_STAGES):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.empty(ch)))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for mod in self.vgg.children():
                bound = mod.weight[0].numel() ** -0.5
                mod.weight.uniform_(-bound, bound, generator=gen)
                mod.bias.zero_()
            for i in range(len(_STAGES)):
                getattr(self, f"lin{i}").uniform_(0.0, 0.1, generator=gen)
        self.requires_grad_(False)  # frozen: a fixed part of the loss
        self.to(device)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b (N, H, W, 3) in [0, 1]."""
        fa = self.vgg(2.0 * a - 1.0)
        fb = self.vgg(2.0 * b - 1.0)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / (torch.linalg.norm(xa, dim=1, keepdim=True) + 1e-10)
            nb = xb / (torch.linalg.norm(xb, dim=1, keepdim=True) + 1e-10)
            diff = (na - nb) ** 2
            head = getattr(self, f"lin{i}").abs()
            total = total + torch.mean(torch.sum(diff * head[None, :, None, None], dim=1), dim=(-2, -1))
        return total
