"""Initial parameters for training from scratch.

The JAX package draws its parameters through the Flax initialisers named in
its modules; `init_parameters` draws the port's the same way, module by
module, from a seeded torch.Generator (the two generators give other numbers,
so the distributions agree, not the values; tests/test_torch_fit_eval.py
holds every leaf's statistics against `EncoderTranSplat.init` of the JAX
package):

  every bias                                   0
  LayerNorm / GroupNorm / BatchNorm scales     1, running statistics 0 / 1
  the second norm of a U-Net ResBlock and the
    norm of a U-Net AttentionBlock             0 (each block starts as the identity)
  backbone.backbone (the CNN)                  N(0, 2 / fan_out)
  backbone.transformer, and the UV matcher's
    value_proj / output_proj                   Xavier uniform
  cross-attention sampling_offsets and
    attention_weights                          0 (samples start on the epipolar grid)
  every other conv / linear kernel             U(+-1 / sqrt(fan_in))
  DAv2 (frozen; real runs load its weights)    cls_token N(0, 1e-6), pos_embed
                                               truncated N(0, 0.02), layer scales 1
"""

from __future__ import annotations

import torch
from torch import nn

from .dav2.vit import DinoVisionTransformer, LayerScale
from .unet import AttentionBlock, ResBlock
from .uv_transformer import UVCrossAttention

_KERNELS = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)
_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d, nn.BatchNorm2d)


def _fans(mod: nn.Module) -> tuple[int, int]:
    """(fan_in, fan_out) as Flax counts them for the kernel of `mod`."""
    w = mod.weight
    if isinstance(mod, nn.Linear):
        return w.shape[1], w.shape[0]
    field = w.shape[2] * w.shape[3]
    if isinstance(mod, nn.ConvTranspose2d):  # weight (in, out, kh, kw)
        return w.shape[0] * field, w.shape[1] * field
    return w.shape[1] * field, w.shape[0] * field


@torch.no_grad()
def init_parameters(encoder: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter of an EncoderTranSplat as the JAX package's
    initialisers do, in place, from `seed`; returns the encoder."""
    gen = torch.Generator(device=next(encoder.parameters()).device).manual_seed(seed)
    zero_scale = set()
    for mod in encoder.modules():
        if isinstance(mod, ResBlock):
            zero_scale.add(mod.out_norm)
        elif isinstance(mod, AttentionBlock):
            zero_scale.add(mod.norm)
    zero_kernel = set()
    for mod in encoder.modules():
        if isinstance(mod, UVCrossAttention):
            zero_kernel.update((mod.sampling_offsets, mod.attention_weights))
    for name, mod in encoder.named_modules():
        if isinstance(mod, _KERNELS):
            fan_in, fan_out = _fans(mod)
            leaf = name.rsplit(".", 1)[-1]
            if mod in zero_kernel:
                mod.weight.zero_()
            elif name.startswith("backbone.backbone."):
                mod.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=gen)
            elif name.startswith("backbone.transformer.") or (".uv_matcher." in name and leaf in ("value_proj", "output_proj")):
                bound = (6.0 / (fan_in + fan_out)) ** 0.5
                mod.weight.uniform_(-bound, bound, generator=gen)
            else:
                bound = fan_in**-0.5
                mod.weight.uniform_(-bound, bound, generator=gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, _NORMS):
            if mod.weight is not None:
                mod.weight.fill_(0.0 if mod in zero_scale else 1.0)
                mod.bias.zero_()
            if isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, LayerScale):
            mod.gamma.fill_(1.0)
        elif isinstance(mod, DinoVisionTransformer):
            mod.cls_token.normal_(0.0, 1e-6, generator=gen)
            nn.init.trunc_normal_(mod.pos_embed, 0.0, 0.02, -0.04, 0.04, generator=gen)
    return encoder
