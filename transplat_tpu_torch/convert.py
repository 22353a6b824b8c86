"""Load the JAX package's variables into the port's modules.

`variables` is the JAX variable tree ({"params": ..., "batch_stats": ...})
as nested dicts of numpy arrays. Port attribute names follow the Flax module
names, so a port tensor `a.b.c.weight` comes from the JAX leaf
`params/a/b/c/<kernel|scale>`; the layout change follows the port module:

  nn.Linear           kernel (in, out)      -> weight (out, in)
  nn.Conv2d           kernel (kh, kw, I, O) -> weight (O, I, kh, kw)
  nn.ConvTranspose2d  kernel (kh, kw, I, O) -> weight (I, O, kh, kw), flipped
  LayerNorm/GroupNorm scale                 -> weight
  BatchNorm           scale / batch_stats mean, var -> weight / running stats
  other parameters    same name, same layout
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_NORMS = (nn.LayerNorm, nn.GroupNorm)
_BATCHNORMS = (nn.BatchNorm1d, nn.BatchNorm2d)


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,)


def _jax_source(mod: nn.Module, tensor_name: str):
    """(collection, leaf name, converter) for one port tensor of `mod`."""
    if isinstance(mod, nn.Linear) and tensor_name == "weight":
        return "params", "kernel", lambda k: k.T
    if isinstance(mod, nn.ConvTranspose2d) and tensor_name == "weight":
        return "params", "kernel", lambda k: k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if isinstance(mod, nn.Conv2d) and tensor_name == "weight":
        return "params", "kernel", lambda k: k.transpose(3, 2, 0, 1)
    if isinstance(mod, _NORMS + _BATCHNORMS) and tensor_name == "weight":
        return "params", "scale", None
    if isinstance(mod, _BATCHNORMS) and tensor_name == "running_mean":
        return "batch_stats", "mean", None
    if isinstance(mod, _BATCHNORMS) and tensor_name == "running_var":
        return "batch_stats", "var", None
    return "params", tensor_name, None


def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Fill every parameter and buffer of `module` from the JAX variable tree.

    Raises KeyError for a port tensor with no JAX leaf, ValueError for a shape
    mismatch or for JAX leaves that no port tensor used."""
    used = set()
    updates = []
    for name, mod in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        tensors = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for tname, tensor in tensors:
            if tname == "num_batches_tracked":  # torch bookkeeping, no JAX counterpart
                continue
            collection, leaf, fn = _jax_source(mod, tname)
            node = variables.get(collection, {})
            for key in path + (leaf,):
                if not isinstance(node, Mapping) or key not in node:
                    raise KeyError(f"no JAX leaf {collection}/{'/'.join(path + (leaf,))} for port tensor {name}.{tname}")
                node = node[key]
            value = np.asarray(node, dtype=np.float32)
            if fn is not None:
                value = fn(value)
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(
                    f"{name}.{tname}: JAX leaf gives shape {value.shape}, port expects {tuple(tensor.shape)}"
                )
            used.add((collection,) + path + (leaf,))
            updates.append((tensor, value))
    unused = sorted(
        "/".join(k)
        for collection in ("params", "batch_stats")
        for k in ((collection,) + p for p in _leaves(variables.get(collection, {})))
        if k not in used
    )
    extra = sorted(set(variables) - {"params", "batch_stats"})
    if unused or extra:
        raise ValueError(f"JAX leaves with no port tensor: {(unused + extra)[:10]} ({len(unused) + len(extra)} total)")
    with torch.no_grad():
        for tensor, value in updates:
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(value)))
    return module
