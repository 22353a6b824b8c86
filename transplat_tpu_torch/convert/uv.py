"""Convert the reference's UV (deformable-attention) transformer weights (the
port's copy of transplat_tpu/convert/uv.py).

Reference: the reference implementation's src/model/utils/{attention.py:145-551,
encoder.py, transformer.py:232-300, ffn.py}. Target: the JAX package's
model.uv_transformer tree.

The coarse transformer's only parameters (attention_weights) are dead: the
softmax runs over a single element (num_levels * num_points == 1), so the
output does not depend on them; the converted tree drops the Linear and the
converter only marks its keys consumed.
"""

from __future__ import annotations

from .common import KeyTracker, convert_linear, convert_norm


def _convert_deform_attn(sd, t: str, params: dict, f: str) -> None:
    for lin in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        convert_linear(sd, f"{t}.{lin}", params, f"{f}/{lin}")


def convert_uv_matcher(coarse_sd: dict, fine_sd: dict, num_fine_layers: int = 2) -> dict:
    """coarse/fine UVTransformer state_dicts -> {'params': ...} for UVMatcher."""
    p: dict = {}

    coarse = KeyTracker(coarse_sd)
    coarse.get("encoder.layers.0.attentions.0.attention_weights.weight")
    coarse.get("encoder.layers.0.attentions.0.attention_weights.bias")
    coarse.assert_all_used("coarse UVTransformer")

    fine = KeyTracker(fine_sd)
    for i in range(num_fine_layers):
        t = f"encoder.layers.{i}"
        f = f"fine_{i}"
        _convert_deform_attn(fine, f"{t}.attentions.0", p, f"{f}/self_attn")
        _convert_deform_attn(fine, f"{t}.attentions.1", p, f"{f}/cross_attn")
        convert_linear(fine, f"{t}.ffns.0.layers.0.0", p, f"{f}/ffn/fc1")
        convert_linear(fine, f"{t}.ffns.0.layers.1", p, f"{f}/ffn/fc2")
        for n in range(3):
            convert_norm(fine, f"{t}.norms.{n}", p, f"{f}/norm{n}")
    fine.assert_all_used("fine UVTransformer")
    return {"params": p}
