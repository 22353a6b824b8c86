"""Load converted weight files (.npy trees) into the port's encoder, driven by config.

Counterpart of transplat_tpu/training/pretrained.py. The files are the ones
the JAX package reads through `checkpointing.pretrained_model` and
`checkpointing.dav2_weights`: numpy trees {"params": ..., "batch_stats": ...}
in the Flax layout. The merge happens in that layout, with the JAX
package's strictness: the encoder's own tensors are laid out as a JAX tree
(`convert.to_jax_tree`), the file's leaves replace their counterparts
(`merge_tree`), and the merged tree is loaded back (`convert.load_jax_variables`).
A partial tree leaves every other tensor as it was, bit for bit (the layout
changes are transposes and flips, which round-trip exactly).

Three tree shapes are accepted, as the JAX package accepts them: a
Lightning / encoder-level tree (params under backbone, da_model,
depth_predictor), a UniMatch tree (a BackboneMultiview subtree, nested under
`backbone`) and a DAv2 tree (nested under `da_model`, which has no
BatchNorm statistics). A Lightning tree may carry the LPIPS network it was
trained with under `lpips_state`; it is taken out and returned.
"""

from __future__ import annotations

import numpy as np
from torch import nn

from ..convert import load_jax_variables, to_jax_tree


def merge_tree(base: dict, override: dict, path: str = "") -> dict:
    """Recursively replace leaves of `base` with leaves of `override`, cast
    to the base leaf's dtype.

    Strict: every override leaf must exist in base with a matching shape
    (KeyError "not present in model tree", ValueError "shape mismatch"), and
    a subtree of the override must be a subtree of base. Error messages name
    the JAX path (a/b/kernel)."""
    out = dict(base)
    for k, v in override.items():
        here = f"{path}/{k}" if path else str(k)
        if k not in base:
            raise KeyError(f"pretrained key '{here}' not present in model tree")
        if isinstance(v, dict):
            if not isinstance(base[k], dict):
                raise ValueError(f"'{here}' is a subtree in the checkpoint but a leaf in the model")
            out[k] = merge_tree(base[k], v, here)
        else:
            b = base[k]
            if tuple(np.shape(b)) != tuple(np.shape(v)):
                raise ValueError(f"shape mismatch at '{here}': model {np.shape(b)} vs checkpoint {np.shape(v)}")
            out[k] = np.asarray(v, dtype=np.asarray(b).dtype)
    return out


def _nest_for_encoder(tree: dict) -> dict:
    """Normalise a converted tree to the encoder level {"params", "batch_stats"}:
    an encoder-level tree as it is, a UniMatch tree (params top keys include
    `transformer`) under `backbone`, anything else under `da_model`."""
    params = tree.get("params", {})
    top = set(params.keys())
    if top <= {"backbone", "da_model", "depth_predictor"}:
        return tree
    if "transformer" in top:  # a BackboneMultiview subtree (UniMatch)
        return {"params": {"backbone": params}, "batch_stats": {"backbone": tree.get("batch_stats", {})}}
    # Anything else: the frozen DAv2 module's subtree.
    return {
        "params": {"da_model": params},
        "batch_stats": {"da_model": tree["batch_stats"]} if tree.get("batch_stats") else {},
    }


def load_pretrained_variables(encoder: nn.Module, ckpt_cfg) -> dict | None:
    """Merge the `ckpt_cfg.pretrained_model` and `ckpt_cfg.dav2_weights` .npy
    trees into `encoder` (in place, in that order). Returns the raw LPIPS
    state embedded in a Lightning tree (its `losses.*` keys), or None."""
    lpips_state = None
    for attr in ("pretrained_model", "dav2_weights"):
        src = getattr(ckpt_cfg, attr, None)
        if not src:
            continue
        tree = np.load(src, allow_pickle=True).item()
        embedded = tree.pop("lpips_state", None)
        if embedded:
            lpips_state = embedded
        tree = _nest_for_encoder(tree)
        variables = to_jax_tree(encoder)
        variables["params"] = merge_tree(variables.get("params", {}), tree.get("params", {}))
        if tree.get("batch_stats"):
            variables["batch_stats"] = merge_tree(variables.get("batch_stats", {}), tree["batch_stats"])
        load_jax_variables(encoder, variables)
    return lpips_state
