"""Whole-encoder and Lightning-checkpoint conversion (the port's copy of
transplat_tpu/convert/encoder.py).

Reference: the reference implementation's src/model/encoder/encoder_trans.py
(EncoderTrans module tree: backbone.*, da_model.*, depth_predictor.*;
gaussian_adapter holds only a non-persistent buffer) and
src/model/model_wrapper.py (Lightning checkpoints prefix every key with
"encoder." / "losses.").

Target: the JAX package's model.encoder.EncoderTranSplat variables
{'params': {backbone, da_model, depth_predictor}, 'batch_stats': {...}}.
"""

from __future__ import annotations

from .backbone import convert_backbone_multiview
from .common import subtree
from .dav2 import convert_dav2
from .depth_predictor import convert_depth_predictor


def convert_encoder(
    state_dict: dict,
    dav2_encoder: str = "vitb",
    costvolume_unet_channel_mult: tuple = (1, 1, 1),
    costvolume_unet_attn_res: tuple = (4,),
    depth_unet_channel_mult: tuple = (1, 1, 1, 1, 1),
    depth_unet_attn_res: tuple = (16,),
) -> dict:
    """EncoderTrans state_dict -> variables for EncoderTranSplat."""
    backbone = convert_backbone_multiview(subtree(state_dict, "backbone"))
    dav2 = convert_dav2(subtree(state_dict, "da_model"), encoder=dav2_encoder)
    dp = convert_depth_predictor(
        subtree(state_dict, "depth_predictor"),
        costvolume_unet_channel_mult=costvolume_unet_channel_mult,
        costvolume_unet_attn_res=costvolume_unet_attn_res,
        depth_unet_channel_mult=depth_unet_channel_mult,
        depth_unet_attn_res=depth_unet_attn_res,
    )
    leftovers = [
        k
        for k in state_dict
        if not k.startswith(("backbone.", "da_model.", "depth_predictor."))
        and not k.endswith("num_batches_tracked")
    ]
    if leftovers:
        raise ValueError(f"unconverted encoder keys: {leftovers[:10]}")
    return {
        "params": {
            "backbone": backbone["params"],
            "da_model": dav2["params"],
            "depth_predictor": dp["params"],
        },
        "batch_stats": {
            "backbone": backbone["batch_stats"],
            "depth_predictor": dp["batch_stats"],
        },
    }


def convert_lightning_checkpoint(ckpt: dict, **encoder_kwargs) -> dict:
    """Full TranSplat Lightning checkpoint -> encoder variables.

    Accepts the raw torch.load result ({'state_dict': ...}) or a bare
    state_dict. Loss-module keys (frozen LPIPS VGG buffers) are returned
    separately under 'lpips_state' for the LPIPS loader.
    """
    sd = ckpt.get("state_dict", ckpt)
    encoder_sd = {k[len("encoder.") :]: v for k, v in sd.items() if k.startswith("encoder.")}
    if not encoder_sd:
        raise ValueError("no 'encoder.' keys found — not a TranSplat Lightning checkpoint?")
    variables = convert_encoder(encoder_sd, **encoder_kwargs)
    lpips_state = {k: v for k, v in sd.items() if k.startswith("losses.")}
    variables["lpips_state"] = lpips_state
    return variables
