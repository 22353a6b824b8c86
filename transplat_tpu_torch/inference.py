"""The serving path: posed context views -> Gaussians -> rendered target views.

Counterpart of the JAX package's forward step (`__graft_entry__.entry`, and
the evaluator's encode/decode pair): EncoderTranSplat, then
decode_splatting, then the colour.
"""

from __future__ import annotations

import torch
from torch import nn

from .config import re10k_config
from .model.decoder import DecoderCfg, decode_splatting
from .model.encoder import EncoderCfg, EncoderTranSplat

_VIEW_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


def re10k_encoder_cfg() -> EncoderCfg:
    """The flagship re10k encoder (config.py `re10k_config`)."""
    return re10k_config().encoder


def re10k_decoder_cfg() -> DecoderCfg:
    """The re10k decoder: black background, 16x16 tiles, float32. (The JAX
    config's worklist capacity has no counterpart: the port drops nothing.)"""
    return re10k_config().decoder


def _views(batch: dict, keys, device) -> dict:
    return {k: torch.as_tensor(batch[k], dtype=torch.float32, device=device) for k in keys if k in batch}


@torch.no_grad()
def render_novel_views(
    encoder: EncoderTranSplat,
    context: dict,
    target: dict,
    image_shape: tuple[int, int],
    decoder_cfg: DecoderCfg | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Encode the context views and render the target cameras.

    context: image (b, v, H, W, 3), intrinsics, extrinsics, near, far;
    target: intrinsics, extrinsics, near, far (numpy arrays or tensors).
    The encoder must live on `device`. Returns colours (b, tv, h, w, 3)."""
    ctx = _views(context, _VIEW_KEYS, device)
    tgt = _views(target, _VIEW_KEYS[1:], device)
    gaussians = encoder(ctx["image"], ctx["intrinsics"], ctx["extrinsics"], ctx["near"], ctx["far"])
    out = decode_splatting(
        gaussians, tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"], image_shape,
        cfg=decoder_cfg or re10k_decoder_cfg(),
    )
    return out.color


def init_random(module: torch.nn.Module, seed: int) -> None:
    """Random weights from a seeded generator: U(+-1/sqrt(fan_in)) for linear
    and conv weights, unit norm scales and layer scales, zero biases, small
    normal tokens; cross-attention offsets and weights perturbed away from
    their zero init; the DAv2 depth head biased positive."""
    gen = torch.Generator(device=next(module.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = mod.weight[0].numel() if not isinstance(mod, nn.ConvTranspose2d) else mod.weight.shape[0]
                b = fan_in**-0.5
                mod.weight.uniform_(-b, b, generator=gen)
                if mod.bias is not None:
                    mod.bias.uniform_(-b, b, generator=gen)
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d, nn.BatchNorm2d)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        vit = module.da_model.pretrained
        vit.cls_token.normal_(0, 0.02, generator=gen)
        vit.pos_embed.normal_(0, 0.02, generator=gen)
        matcher = module.depth_predictor.uv_matcher
        for i in range(matcher.num_fine_layers):
            cross = getattr(matcher, f"fine_{i}").cross_attn
            cross.sampling_offsets.weight.normal_(0, 0.02, generator=gen)
            cross.sampling_offsets.bias.normal_(0, 0.5, generator=gen)
            cross.attention_weights.weight.normal_(0, 0.02, generator=gen)
            cross.attention_weights.bias.normal_(0, 0.5, generator=gen)
        head = module.da_model.depth_head
        head.output_conv2_0.bias.add_(0.5)
        head.output_conv2_2.bias.add_(1.0)
