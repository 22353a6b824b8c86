"""Convert the reference's LDM U-Net weights to the Flax UNetModel tree (the
port's copy of transplat_tpu/convert/unet.py).

Reference: the reference implementation's
src/model/encoder/matching/ldm_unet/unet.py:589-1100 (postnorm, no timestep:
the only configuration the model builds). Target: the JAX package's
model.unet.UNetModel tree.

The reference stores blocks in flat nn.ModuleLists (input_blocks /
middle_block / output_blocks); they are walked with the same level / ds
bookkeeping as both forward passes use.
"""

from __future__ import annotations

import numpy as np

from .common import KeyTracker, convert_norm, set_in, t2f_conv, t2f_linear


def _conv1d_to_dense(w) -> np.ndarray:
    """torch Conv1d kernel (O, I, 1) -> flax Dense kernel (I, O)."""
    return t2f_linear(np.asarray(w)[:, :, 0])


def _convert_resblock(sd, t: str, params: dict, f: str) -> None:
    set_in(params, f"{f}/in_conv/kernel", t2f_conv(sd[f"{t}.in_layers.0.weight"]))
    set_in(params, f"{f}/in_conv/bias", np.asarray(sd[f"{t}.in_layers.0.bias"]))
    convert_norm(sd, f"{t}.in_layers.1", params, f"{f}/in_norm")
    set_in(params, f"{f}/out_conv/kernel", t2f_conv(sd[f"{t}.out_layers.0.weight"]))
    set_in(params, f"{f}/out_conv/bias", np.asarray(sd[f"{t}.out_layers.0.bias"]))
    convert_norm(sd, f"{t}.out_layers.1", params, f"{f}/out_norm")
    if f"{t}.skip_connection.weight" in sd:
        set_in(params, f"{f}/skip/kernel", t2f_conv(sd[f"{t}.skip_connection.weight"]))
        set_in(params, f"{f}/skip/bias", np.asarray(sd[f"{t}.skip_connection.bias"]))


def _convert_attn(sd, t: str, params: dict, f: str) -> None:
    set_in(params, f"{f}/qkv/kernel", _conv1d_to_dense(sd[f"{t}.qkv.weight"]))
    set_in(params, f"{f}/qkv/bias", np.asarray(sd[f"{t}.qkv.bias"]))
    set_in(params, f"{f}/proj_out/kernel", _conv1d_to_dense(sd[f"{t}.proj_out.weight"]))
    set_in(params, f"{f}/proj_out/bias", np.asarray(sd[f"{t}.proj_out.bias"]))
    convert_norm(sd, f"{t}.norm", params, f"{f}/norm")


def convert_unet(
    state_dict: dict,
    channel_mult: tuple = (1, 1, 1),
    num_res_blocks: int = 1,
    attention_resolutions: tuple = (),
) -> dict:
    """UNetModel state_dict -> {'params': ...} for model.unet.UNetModel."""
    sd = KeyTracker({k: np.asarray(v) for k, v in state_dict.items()})
    p: dict = {}
    attn_res = set(attention_resolutions)
    levels = len(channel_mult)

    set_in(p, "in_conv/kernel", t2f_conv(sd["input_blocks.0.0.weight"]))
    set_in(p, "in_conv/bias", np.asarray(sd["input_blocks.0.0.bias"]))

    idx, ds = 1, 1
    for level in range(levels):
        for i in range(num_res_blocks):
            _convert_resblock(sd, f"input_blocks.{idx}.0", p, f"down_{level}_{i}")
            if ds in attn_res:
                _convert_attn(sd, f"input_blocks.{idx}.1", p, f"down_{level}_{i}_attn")
            idx += 1
        if level != levels - 1:
            set_in(p, f"downsample_{level}/kernel", t2f_conv(sd[f"input_blocks.{idx}.0.op.weight"]))
            set_in(p, f"downsample_{level}/bias", np.asarray(sd[f"input_blocks.{idx}.0.op.bias"]))
            idx += 1
            ds *= 2

    _convert_resblock(sd, "middle_block.0", p, "middle_0")
    _convert_resblock(sd, "middle_block.2", p, "middle_1")

    o = 0
    for level in reversed(range(levels)):
        for i in range(num_res_blocks + 1):
            _convert_resblock(sd, f"output_blocks.{o}.0", p, f"up_{level}_{i}")
            sub = 1
            if ds in attn_res:
                _convert_attn(sd, f"output_blocks.{o}.{sub}", p, f"up_{level}_{i}_attn")
                sub += 1
            if level and i == num_res_blocks:
                set_in(p, f"upsample_{level}/kernel", t2f_conv(sd[f"output_blocks.{o}.{sub}.conv.weight"]))
                set_in(p, f"upsample_{level}/bias", np.asarray(sd[f"output_blocks.{o}.{sub}.conv.bias"]))
                ds //= 2
            o += 1

    set_in(p, "out_conv/kernel", t2f_conv(sd["out.0.weight"]))
    set_in(p, "out_conv/bias", np.asarray(sd["out.0.bias"]))
    convert_norm(sd, "out.1", p, "out_norm")
    sd.assert_all_used("UNetModel")
    return {"params": p}
