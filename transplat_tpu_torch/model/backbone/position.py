"""Sine/cosine 2D positional encoding per split window, counterpart of
transplat_tpu/model/backbone/position.py."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...utils.constants import device_array


@lru_cache(maxsize=16)
def position_embedding_sine(h: int, w: int, num_pos_feats: int = 64, temperature: float = 10000.0) -> np.ndarray:
    """(h, w, 2*num_pos_feats) static positional encoding."""
    eps = 1e-6
    scale = 2.0 * np.pi
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :] * np.ones((h, 1), np.float32)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2.0 * (dim_t // 2) / num_pos_feats)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1)


def position_windowed(h: int, w: int, splits: int, feature_channels: int) -> np.ndarray:
    """(h, w, feature_channels) sine positions, local to each of splits x splits windows."""
    if splits > 1:
        return np.tile(position_embedding_sine(h // splits, w // splits, feature_channels // 2), (splits, splits, 1))
    return position_embedding_sine(h, w, feature_channels // 2)


def add_position_windowed(features: torch.Tensor, splits: int, feature_channels: int) -> torch.Tensor:
    """Add window-local sine positions to (N, H, W, C) features."""
    _, h, w, _ = features.shape
    return features + device_array(position_windowed, h, w, splits, feature_channels, device=features.device,
                                   dtype=features.dtype)
