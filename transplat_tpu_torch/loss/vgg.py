"""VGG16 feature extractor + LPIPS perceptual distance.

Counterpart of transplat_tpu/loss/vgg.py (the lpips package's VGG variant):
five conv stages tapped after relu1_2 / relu2_2 / relu3_3 / relu4_3 /
relu5_3, unit-normalised over channels, non-negative 1x1 heads, spatial mean.
Plain convolutions, no hand-written kernel. `dtype` (forward's argument, the
JAX modules' attribute) runs the convolution stack in bfloat16 with float32
parameters, as the training loss does under the encoder's compute_dtype;
the scores are float32 either way, and the evaluator's LPIPS is float32. Module and parameter names
follow the Flax modules (`vgg.conv{i}`, `lin{i}`), so
convert.load_jax_variables fills them from {"params": lpips_params}.

Calibrated LPIPS weights are not part of the repository: the module starts
from a random initialisation (same compute as calibrated weights, not a
calibrated perceptual metric). `load_lpips_weights` fills it from converted
lpips(net='vgg') torch weights, and `init_lpips` builds a loaded module from
such a state dict, as `init_lpips_params` of the JAX package's
training/step.py does.
"""

from __future__ import annotations

import numpy as np
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


def _conv_index(key: str) -> int | None:
    """The torchvision feature index of a VGG conv weight key, or None."""
    parts = key.split(".")
    if not key.endswith(".weight") or "model" in parts:
        return None
    if not ("features" in parts or any(p.startswith("slice") for p in parts)):
        return None
    try:
        return int(parts[-2])  # torchvision's feature index (globally unique)
    except ValueError:
        return None


def load_lpips_weights(lpips: LPIPS, torch_state_dict: dict, strict: bool = True) -> LPIPS:
    """Fill `lpips` (in place) from converted lpips(net='vgg') torch weights.

    torch_state_dict: a flat dict of arrays in either naming, torchvision's
    (`features.N.weight`) or the lpips package's slices (`net.sliceK.N.weight`,
    N torchvision's global feature index), under any prefix (a Lightning
    checkpoint's `losses.*.lpips.`). The convs fill conv0, conv1, ... in the
    order of their feature index; the heads are the keys ending
    `lin{i}.model.1.weight`. strict: exactly 13 convs and 5 heads, else
    ValueError (a partial load would leave random convs behind)."""
    conv_keys = sorted((k for k in torch_state_dict if _conv_index(k) is not None), key=_conv_index)
    if strict and len(conv_keys) != 13:
        raise ValueError(f"expected 13 VGG conv weights, matched {len(conv_keys)}: {conv_keys[:4]}...")
    updates = []
    for i, wk in enumerate(conv_keys):
        conv = getattr(lpips.vgg, f"conv{i}")
        bk = wk[: -len("weight")] + "bias"
        updates += [(conv.weight, torch_state_dict[wk]), (conv.bias, torch_state_dict[bk])]
    n_heads = 0
    for i in range(len(_STAGES)):
        suffix = f"lin{i}.model.1.weight"
        for key in torch_state_dict:
            if key.endswith(suffix):
                updates.append((getattr(lpips, f"lin{i}"), np.asarray(torch_state_dict[key]).reshape(-1)))
                n_heads += 1
                break
    if strict and n_heads != 5:
        raise ValueError(f"expected 5 LPIPS linear heads, matched {n_heads}")
    with torch.no_grad():
        for tensor, value in updates:
            value = torch.as_tensor(np.asarray(value, dtype=np.float32))
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"LPIPS weight of shape {tuple(value.shape)} where {tuple(tensor.shape)} is expected")
            tensor.copy_(value)
    return lpips


def init_lpips(torch_state: dict | None, device="cuda") -> LPIPS | None:
    """A frozen LPIPS on `device` loaded from converted torch weights, or None
    when there are none: a random-init LPIPS is a noise term in the loss,
    so the trainer leaves the perceptual term out without weights."""
    if torch_state is None:
        return None
    return load_lpips_weights(LPIPS(device=device), torch_state)
