"""Constant tensors that a forward needs on its device, made there once.

A forward that writes a constant to the card at every call (an interpolation
matrix, a window mask, `torch.tensor([w, h], device=...)`) makes the host
wait for the copy, and cannot be captured into a CUDA graph (utils/graphs.py).
`device_constant` and `device_array` make such a constant on its device at
the first call for its values and keep it: later calls copy nothing. The
tensor is shared by every caller: read it, never write it.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=512)
def _on_device(build, args: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(build(*args), dtype=dtype).to(device)


def device_constant(values: tuple, like: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype or like.dtype, device=like.device)`
    for a (nested) tuple of numbers, made once."""
    return _on_device(tuple, (values,), like.device, like.dtype if dtype is None else dtype)


def device_array(build, *args, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The numpy array `build(*args)` as a tensor in `dtype` on `device`,
    made once for these arguments; `build` is a module-level function of
    hashable arguments."""
    return _on_device(build, args, torch.device(device), dtype)

