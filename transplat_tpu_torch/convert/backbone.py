"""Convert the reference's matching-backbone weights to Flax trees (the
port's copy of transplat_tpu/convert/backbone.py).

Reference modules (torch, the reference implementation's src/):
  model/encoder/backbone/backbone_multiview.py:36-133
  model/encoder/backbone/unimatch/backbone.py:39-117
  model/utils/cam_param_encoder.py:45-93
  model/encoder/backbone/multiview_transformer.py:410-492

Targets: the JAX package's model.backbone.{cnn,multiview,transformer} and
model.cam_encoder trees, which the port's modules load
(`convert.load_jax_variables`).
"""

from __future__ import annotations

from .common import (
    KeyTracker,
    convert_batchnorm,
    convert_conv,
    convert_linear,
    convert_norm,
    set_in,
    subtree,
)

_CNN_LAYERS = (
    "layer1.0",
    "layer1.1",
    "layer2.0",
    "layer2.1",
    "layer3.0",
    "layer3.1",
)


def convert_cnn_encoder(sd, params: dict, base: str = "backbone") -> None:
    """unimatch CNNEncoder (InstanceNorm affine=False => convs only)."""
    convert_conv(sd, f"{base}.conv1", params, f"{base}/conv1", bias=False)
    for t_name in _CNN_LAYERS:
        f_name = t_name.replace(".", "_")
        for c in ("conv1", "conv2"):
            convert_conv(sd, f"{base}.{t_name}.{c}", params, f"{base}/{f_name}/{c}", bias=False)
        if f"{base}.{t_name}.downsample.0.weight" in sd:
            convert_conv(
                sd, f"{base}.{t_name}.downsample.0", params, f"{base}/{f_name}/downsample"
            )
    convert_conv(sd, f"{base}.conv2", params, f"{base}/conv2")


def convert_cam_param_encoder(sd, params: dict, stats: dict, base: str) -> None:
    """cam_param_encoder: BN(16) -> MLP -> SE -> 1x1 conv."""
    convert_batchnorm(sd, f"{base}.bn", params, stats, f"{base}/bn")
    convert_conv(sd, f"{base}.reduce_conv.0", params, f"{base}/reduce_conv_0")
    convert_batchnorm(sd, f"{base}.reduce_conv.1", params, stats, f"{base}/reduce_bn")
    for fc in ("fc1", "fc2"):
        convert_linear(sd, f"{base}.context_mlp.{fc}", params, f"{base}/context_mlp/{fc}")
    for c in ("conv_reduce", "conv_expand"):
        convert_conv(sd, f"{base}.context_se.{c}", params, f"{base}/context_se/{c}")
    convert_conv(sd, f"{base}.context_conv", params, f"{base}/context_conv")


def convert_multiview_transformer(sd, params: dict, base: str, num_layers: int = 6) -> None:
    """6x TransformerBlock: self_attn + cross_attn_ffn (q/k/v/merge no-bias
    Dense, LayerNorms, FFN mlp.0/mlp.2)."""
    for i in range(num_layers):
        t = f"{base}.layers.{i}"
        f = f"{base}/layer_{i}"
        for blk in ("self_attn", "cross_attn_ffn"):
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                convert_linear(sd, f"{t}.{blk}.{proj}", params, f"{f}/{blk}/{proj}", bias=False)
            convert_norm(sd, f"{t}.{blk}.norm1", params, f"{f}/{blk}/norm1")
        convert_linear(sd, f"{t}.cross_attn_ffn.mlp.0", params, f"{f}/cross_attn_ffn/mlp_0", bias=False)
        convert_linear(sd, f"{t}.cross_attn_ffn.mlp.2", params, f"{f}/cross_attn_ffn/mlp_2", bias=False)
        convert_norm(sd, f"{t}.cross_attn_ffn.norm2", params, f"{f}/cross_attn_ffn/norm2")


def convert_backbone_multiview(sd: dict, num_layers: int = 6) -> dict:
    """Full BackboneMultiview state_dict -> Flax variables
    {'params': ..., 'batch_stats': ...} for model.backbone.BackboneMultiview."""
    tracker = KeyTracker(sd)
    params: dict = {}
    stats: dict = {}
    convert_cnn_encoder(tracker, params, "backbone")
    convert_cam_param_encoder(tracker, params, stats, "cam_param_encoder")
    convert_multiview_transformer(tracker, params, "transformer", num_layers)
    tracker.assert_all_used("BackboneMultiview")
    return {"params": params, "batch_stats": stats}


def convert_unimatch_checkpoint(sd: dict, num_layers: int = 6) -> dict:
    """UniMatch gmdepth checkpoint -> Flax variables for the CNN + transformer
    part of BackboneMultiview (the reference's partial load,
    encoder_trans.py:84-98: only keys present in both trees transfer — i.e.
    backbone.* and the transformer.* layers; cam_param_encoder stays init).

    The gmdepth checkpoint stores the full UniMatch model; we take `backbone.`
    (CNNEncoder) and `transformer.` (6 matching layers whose module tree is
    identical to MultiViewFeatureTransformer's TransformerBlock layout).
    """
    params: dict = {}
    cnn_sd = {f"backbone.{k}": v for k, v in subtree(sd, "backbone").items()}
    convert_cnn_encoder(cnn_sd, params, "backbone")

    trans_sd = {f"transformer.{k}": v for k, v in subtree(sd, "transformer").items()}
    # gmdepth's transformer blocks may be fewer/more; convert what exists.
    n = 0
    while f"transformer.layers.{n}.self_attn.q_proj.weight" in trans_sd:
        n += 1
    convert_multiview_transformer(trans_sd, params, "transformer", min(n, num_layers))
    return {"params": params, "batch_stats": {}}


__all__ = [
    "convert_backbone_multiview",
    "convert_cnn_encoder",
    "convert_cam_param_encoder",
    "convert_multiview_transformer",
    "convert_unimatch_checkpoint",
    "set_in",
]
