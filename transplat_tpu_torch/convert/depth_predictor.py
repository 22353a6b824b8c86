"""Convert the reference's DepthPredictorTrans weights to the Flax
DepthPredictor tree (the port's copy of transplat_tpu/convert/depth_predictor.py).

Reference: the reference implementation's
src/model/encoder/matching/depth_predictor_trans.py:110-234 (constructor;
forward :292-493). Target: the JAX package's model.depth_predictor tree.
"""

from __future__ import annotations

from .backbone import convert_cam_param_encoder
from .common import KeyTracker, convert_conv, convert_norm, subtree
from .unet import convert_unet
from .uv import convert_uv_matcher


def convert_depth_predictor(
    state_dict: dict,
    costvolume_unet_channel_mult: tuple = (1, 1, 1),
    costvolume_unet_attn_res: tuple = (4,),
    depth_unet_channel_mult: tuple = (1, 1, 1, 1, 1),
    depth_unet_attn_res: tuple = (16,),
) -> dict:
    """DepthPredictorTrans state_dict -> variables for DepthPredictor."""
    sd = KeyTracker(state_dict)
    p: dict = {}
    stats: dict = {}

    # cost-volume stem + U-Net + head
    convert_conv(sd, "corr_refine_net.0", p, "corr_conv_in")
    convert_norm(sd, "corr_refine_net.1", p, "corr_norm_in")
    unet_vars = convert_unet(
        subtree(sd.sd, "corr_refine_net.3"),
        channel_mult=costvolume_unet_channel_mult,
        num_res_blocks=1,
        attention_resolutions=costvolume_unet_attn_res,
    )
    p["corr_unet"] = unet_vars["params"]
    for k in sd.sd:
        if k.startswith("corr_refine_net.3."):
            sd.used.add(k)
    convert_conv(sd, "corr_refine_net.4", p, "corr_conv_out")
    convert_conv(sd, "regressor_residual", p, "regressor_residual")

    convert_conv(sd, "depth_head_lowres.0", p, "depth_head_0")
    convert_conv(sd, "depth_head_lowres.2", p, "depth_head_2")

    convert_conv(sd, "upsampler.0", p, "upsampler_conv")
    convert_conv(sd, "proj_feature", p, "proj_feature")

    convert_conv(sd, "refine_unet.0", p, "refine_conv_in")
    convert_norm(sd, "refine_unet.1", p, "refine_norm_in")
    refine_vars = convert_unet(
        subtree(sd.sd, "refine_unet.3"),
        channel_mult=depth_unet_channel_mult,
        num_res_blocks=1,
        attention_resolutions=depth_unet_attn_res,
    )
    p["refine_unet"] = refine_vars["params"]
    for k in sd.sd:
        if k.startswith("refine_unet.3."):
            sd.used.add(k)

    convert_conv(sd, "to_gaussians.0", p, "to_gaussians_0")
    convert_conv(sd, "to_gaussians.2", p, "to_gaussians_2")
    convert_conv(sd, "to_disparity.0", p, "to_disparity_0")
    convert_conv(sd, "to_disparity.2", p, "to_disparity_2")

    uv_vars = convert_uv_matcher(
        subtree(sd.sd, "coarse_transformer"), subtree(sd.sd, "fine_transformer")
    )
    p["uv_matcher"] = uv_vars["params"]
    for k in sd.sd:
        if k.startswith(("coarse_transformer.", "fine_transformer.")):
            sd.used.add(k)

    convert_cam_param_encoder(sd, p, stats, "cam_param_encoder")
    sd.assert_all_used("DepthPredictorTrans")
    return {"params": p, "batch_stats": stats}
