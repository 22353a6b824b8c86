"""Move variables between the JAX package's tree layout and the port's modules.

`load_jax_variables` fills a port module (the encoder, or LPIPS from
{"params": lpips_params}) from a JAX variable tree; `to_jax_tree` lays the
port's own tensors, or per-parameter values such as gradients and optimizer
moments, out in that tree, so both packages are compared leaf by leaf.

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
    """(collection, leaf name, JAX -> port converter, port -> JAX converter)
    for one port tensor of `mod`; a converter of None is the identity."""
    if isinstance(mod, nn.Linear) and tensor_name == "weight":
        return "params", "kernel", lambda k: k.T, lambda w: w.T
    if isinstance(mod, nn.ConvTranspose2d) and tensor_name == "weight":
        return (
            "params", "kernel",
            lambda k: k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1],
            lambda w: w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1),
        )
    if isinstance(mod, nn.Conv2d) and tensor_name == "weight":
        return "params", "kernel", lambda k: k.transpose(3, 2, 0, 1), lambda w: w.transpose(2, 3, 1, 0)
    if isinstance(mod, _NORMS + _BATCHNORMS) and tensor_name == "weight":
        return "params", "scale", None, None
    if isinstance(mod, _BATCHNORMS) and tensor_name == "running_mean":
        return "batch_stats", "mean", None, None
    if isinstance(mod, _BATCHNORMS) and tensor_name == "running_var":
        return "batch_stats", "var", None, None
    return "params", tensor_name, None, None


def _port_tensors(module: nn.Module):
    """(module name, module, tensor name, tensor) for every parameter and
    buffer that has a JAX leaf."""
    for name, mod in module.named_modules():
        tensors = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for tname, tensor in tensors:
            if tname != "num_batches_tracked":  # torch bookkeeping, no JAX counterpart
                yield name, mod, tname, tensor


def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Fill every parameter and buffer of `module` from the JAX variable tree.

    Raises KeyError for a port tensor with no JAX leaf, ValueError for a shape
    mismatch or for JAX leaves that no port tensor used."""
    used = set()
    updates = []
    for name, mod, tname, tensor in _port_tensors(module):
        path = tuple(name.split(".")) if name else ()
        collection, leaf, fn, _ = _jax_source(mod, tname)
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


def to_jax_tree(module: nn.Module, values: Mapping[str, torch.Tensor] | None = None) -> dict:
    """The port's tensors in the JAX tree layout, as numpy arrays.

    With `values` None: every parameter and buffer of `module`, as
    {"params": ..., "batch_stats": ...} (the inverse of `load_jax_variables`).
    With `values` (tensors by parameter name, e.g. the gradients or the Adam
    moments of a training step): those, laid out and converted like the
    parameters they belong to, as {"params": ...} holding only the named
    leaves."""
    tree: dict = {}
    for name, mod, tname, tensor in _port_tensors(module):
        full = f"{name}.{tname}" if name else tname
        if values is not None:
            if full not in values:
                continue
            tensor = values[full]
        collection, leaf, _, inverse = _jax_source(mod, tname)
        value = tensor.detach().cpu().numpy()
        node = tree.setdefault(collection, {})
        for key in (name.split(".") if name else []):
            node = node.setdefault(key, {})
        node[leaf] = np.array(value if inverse is None else inverse(value), order="C")  # a copy, not a view
    return tree
