"""Convert Depth-Anything-V2 torch checkpoints to Flax params (the port's copy
of transplat_tpu/convert/dav2.py).

Reference: the reference implementation's src/depth_anything_v2/{dpt.py:154-222,
dinov2.py}. Target: the JAX package's model.dav2.DepthAnythingV2 tree
(params only, no batch stats; the prior runs frozen).
"""

from __future__ import annotations

import numpy as np

from .common import KeyTracker, set_in, t2f_conv, t2f_convT, t2f_linear

_DEPTHS = {"vits": 12, "vitb": 12, "vitl": 24}


def convert_dav2(state_dict: dict, encoder: str = "vitb") -> dict:
    """DAv2 state_dict -> {'params': ...} for model.dav2.DepthAnythingV2."""
    sd = KeyTracker({k: np.asarray(v) for k, v in state_dict.items()})
    p: dict = {}

    # --- DINOv2 ViT ("pretrained")
    set_in(p, "pretrained/patch_embed/kernel", t2f_conv(sd["pretrained.patch_embed.proj.weight"]))
    set_in(p, "pretrained/patch_embed/bias", sd["pretrained.patch_embed.proj.bias"])
    set_in(p, "pretrained/cls_token", sd["pretrained.cls_token"])
    set_in(p, "pretrained/pos_embed", sd["pretrained.pos_embed"])
    sd.get("pretrained.mask_token")  # unused: masking is train-time only
    for i in range(_DEPTHS[encoder]):
        b = f"pretrained.blocks.{i}"
        o = f"pretrained/block_{i}"
        set_in(p, f"{o}/norm1/scale", sd[f"{b}.norm1.weight"])
        set_in(p, f"{o}/norm1/bias", sd[f"{b}.norm1.bias"])
        set_in(p, f"{o}/attn/qkv/kernel", t2f_linear(sd[f"{b}.attn.qkv.weight"]))
        set_in(p, f"{o}/attn/qkv/bias", sd[f"{b}.attn.qkv.bias"])
        set_in(p, f"{o}/attn/proj/kernel", t2f_linear(sd[f"{b}.attn.proj.weight"]))
        set_in(p, f"{o}/attn/proj/bias", sd[f"{b}.attn.proj.bias"])
        set_in(p, f"{o}/ls1/gamma", sd[f"{b}.ls1.gamma"])
        set_in(p, f"{o}/norm2/scale", sd[f"{b}.norm2.weight"])
        set_in(p, f"{o}/norm2/bias", sd[f"{b}.norm2.bias"])
        set_in(p, f"{o}/mlp_fc1/kernel", t2f_linear(sd[f"{b}.mlp.fc1.weight"]))
        set_in(p, f"{o}/mlp_fc1/bias", sd[f"{b}.mlp.fc1.bias"])
        set_in(p, f"{o}/mlp_fc2/kernel", t2f_linear(sd[f"{b}.mlp.fc2.weight"]))
        set_in(p, f"{o}/mlp_fc2/bias", sd[f"{b}.mlp.fc2.bias"])
        set_in(p, f"{o}/ls2/gamma", sd[f"{b}.ls2.gamma"])
    set_in(p, "pretrained/norm/scale", sd["pretrained.norm.weight"])
    set_in(p, "pretrained/norm/bias", sd["pretrained.norm.bias"])

    # --- DPT head
    for i in range(4):
        set_in(p, f"depth_head/project_{i}/kernel", t2f_conv(sd[f"depth_head.projects.{i}.weight"]))
        set_in(p, f"depth_head/project_{i}/bias", sd[f"depth_head.projects.{i}.bias"])
    set_in(p, "depth_head/resize_0/kernel", t2f_convT(sd["depth_head.resize_layers.0.weight"]))
    set_in(p, "depth_head/resize_0/bias", sd["depth_head.resize_layers.0.bias"])
    set_in(p, "depth_head/resize_1/kernel", t2f_convT(sd["depth_head.resize_layers.1.weight"]))
    set_in(p, "depth_head/resize_1/bias", sd["depth_head.resize_layers.1.bias"])
    set_in(p, "depth_head/resize_3/kernel", t2f_conv(sd["depth_head.resize_layers.3.weight"]))
    set_in(p, "depth_head/resize_3/bias", sd["depth_head.resize_layers.3.bias"])
    for i in range(4):
        set_in(
            p, f"depth_head/layer{i + 1}_rn/kernel",
            t2f_conv(sd[f"depth_head.scratch.layer{i + 1}_rn.weight"]),
        )
    for i in range(1, 5):
        b = f"depth_head.scratch.refinenet{i}"
        o = f"depth_head/refinenet{i}"
        for unit in ("resConfUnit1", "resConfUnit2"):
            for conv_i in ("conv1", "conv2"):
                set_in(p, f"{o}/{unit}/{conv_i}/kernel", t2f_conv(sd[f"{b}.{unit}.{conv_i}.weight"]))
                set_in(p, f"{o}/{unit}/{conv_i}/bias", sd[f"{b}.{unit}.{conv_i}.bias"])
        set_in(p, f"{o}/out_conv/kernel", t2f_conv(sd[f"{b}.out_conv.weight"]))
        set_in(p, f"{o}/out_conv/bias", sd[f"{b}.out_conv.bias"])
    set_in(p, "depth_head/output_conv1/kernel", t2f_conv(sd["depth_head.scratch.output_conv1.weight"]))
    set_in(p, "depth_head/output_conv1/bias", sd["depth_head.scratch.output_conv1.bias"])
    set_in(p, "depth_head/output_conv2_0/kernel", t2f_conv(sd["depth_head.scratch.output_conv2.0.weight"]))
    set_in(p, "depth_head/output_conv2_0/bias", sd["depth_head.scratch.output_conv2.0.bias"])
    set_in(p, "depth_head/output_conv2_2/kernel", t2f_conv(sd["depth_head.scratch.output_conv2.2.weight"]))
    set_in(p, "depth_head/output_conv2_2/bias", sd["depth_head.scratch.output_conv2.2.bias"])
    sd.assert_all_used("DepthAnythingV2")
    return {"params": p}
