"""Torch -> Flax weight-layout primitives (the port's copy of
transplat_tpu/convert/common.py).

Layout rules (torch -> flax):
  Conv2d          weight (O, I, kh, kw) -> kernel (kh, kw, I, O)
  ConvTranspose2d weight (I, O, kh, kw) -> spatial flip, then (kh, kw, I, O)
  Linear          weight (O, I)         -> kernel (I, O)
  Norm layers     weight/bias           -> scale/bias
  BatchNorm       running_mean/var      -> batch_stats collection {mean, var}
"""

from __future__ import annotations

import numpy as np


def t2f_conv(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def t2f_convT(w) -> np.ndarray:
    # torch ConvTranspose2d correlates with the kernel flipped relative to
    # lax.conv_transpose; flip spatial dims then (I,O,kh,kw)->(kh,kw,I,O).
    # Verified numerically against torch for k=s and k!=s cases.
    w = np.asarray(w)[:, :, ::-1, ::-1]
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def t2f_linear(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (1, 0))


def as_np(sd: dict) -> dict:
    """Torch state_dict -> plain numpy dict (accepts tensors or ndarrays)."""
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def set_in(tree: dict, path: str, value) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def get_in(tree: dict, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def subtree(sd: dict, prefix: str) -> dict:
    """Select keys under `prefix.` and strip it."""
    plen = len(prefix) + 1
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


class KeyTracker:
    """Wraps a state_dict; records which keys conversion consumed so callers
    can assert nothing was silently dropped (ignoring torch bookkeeping)."""

    IGNORED_SUFFIXES = ("num_batches_tracked",)

    def __init__(self, sd: dict):
        self.sd = sd
        self.used: set[str] = set()

    def __getitem__(self, key: str):
        self.used.add(key)
        return self.sd[key]

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def get(self, key: str, default=None):
        if key in self.sd:
            return self[key]
        return default

    def unused(self) -> list[str]:
        return sorted(
            k
            for k in self.sd
            if k not in self.used and not k.endswith(self.IGNORED_SUFFIXES)
        )

    def assert_all_used(self, context: str = "") -> None:
        leftovers = self.unused()
        if leftovers:
            raise ValueError(
                f"unconverted keys{' in ' + context if context else ''}: "
                f"{leftovers[:10]}{' ...' if len(leftovers) > 10 else ''} "
                f"({len(leftovers)} total)"
            )


def convert_batchnorm(sd, t_prefix: str, params: dict, stats: dict, f_path: str) -> None:
    """torch BatchNorm{1,2}d -> flax nn.BatchNorm (params + batch_stats)."""
    set_in(params, f"{f_path}/scale", np.asarray(sd[f"{t_prefix}.weight"]))
    set_in(params, f"{f_path}/bias", np.asarray(sd[f"{t_prefix}.bias"]))
    set_in(stats, f"{f_path}/mean", np.asarray(sd[f"{t_prefix}.running_mean"]))
    set_in(stats, f"{f_path}/var", np.asarray(sd[f"{t_prefix}.running_var"]))


def convert_norm(sd, t_prefix: str, params: dict, f_path: str) -> None:
    """torch LayerNorm/GroupNorm -> flax scale/bias."""
    set_in(params, f"{f_path}/scale", np.asarray(sd[f"{t_prefix}.weight"]))
    set_in(params, f"{f_path}/bias", np.asarray(sd[f"{t_prefix}.bias"]))


def convert_conv(sd, t_key: str, params: dict, f_path: str, bias: bool | None = None) -> None:
    set_in(params, f"{f_path}/kernel", t2f_conv(sd[f"{t_key}.weight"]))
    bkey = f"{t_key}.bias"
    if bias is True or (bias is None and bkey in sd):
        set_in(params, f"{f_path}/bias", np.asarray(sd[bkey]))


def convert_linear(sd, t_key: str, params: dict, f_path: str, bias: bool | None = None) -> None:
    set_in(params, f"{f_path}/kernel", t2f_linear(sd[f"{t_key}.weight"]))
    bkey = f"{t_key}.bias"
    if bias is True or (bias is None and bkey in sd):
        set_in(params, f"{f_path}/bias", np.asarray(sd[bkey]))
