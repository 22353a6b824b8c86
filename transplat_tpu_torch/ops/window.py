"""Swin-style window partitioning and single-head window attention.

Counterpart of transplat_tpu/ops/window.py: plain matmul + softmax over
(num_windows, window_len, C) blocks. The shifted-window mask is built on the
device of the activations from a small numpy map of window regions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.constants import device_array


def window_partition(x: torch.Tensor, splits: int) -> torch.Tensor:
    """(N, H, W, C) -> (N * splits^2, H/splits, W/splits, C)."""
    n, h, w, c = x.shape
    s = splits
    x = x.reshape(n, s, h // s, s, w // s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n * s * s, h // s, w // s, c)


def window_merge(x: torch.Tensor, splits: int) -> torch.Tensor:
    """Inverse of window_partition."""
    ns, hs, ws, c = x.shape
    s = splits
    n = ns // (s * s)
    x = x.reshape(n, s, s, hs, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, s * hs, s * ws, c)


def window_regions(h: int, w: int, window_h: int, window_w: int, shift_h: int, shift_w: int) -> np.ndarray:
    """(num_windows, wl) int64: the shifted-window region of each pixel of each window."""
    img_mask = np.zeros((h, w), np.int64)
    cnt = 0
    for hs in (slice(0, -window_h), slice(-window_h, -shift_h), slice(-shift_h, None)):
        for ws in (slice(0, -window_w), slice(-window_w, -shift_w), slice(-shift_w, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    s = w // window_w
    return img_mask.reshape(s, window_h, s, window_w).transpose(0, 2, 1, 3).reshape(s * s, window_h * window_w)


def key_order(m: int, wl: int) -> np.ndarray:
    """The mask's key column of each of m views' wl window keys, tiled
    pixel-major over view-major keys (the reference's quirk for m > 1)."""
    i_idx, l_idx = np.divmod(np.arange(m * wl), wl)
    return (l_idx * m + i_idx) % wl


def shifted_window_mask(h: int, w: int, window_h: int, window_w: int, shift_h: int, shift_w: int, device=None) -> torch.Tensor:
    """Additive attention mask (num_windows, wl, wl) for shifted windows, built
    on `device` (a (4, 1024, 1024) mask at the flagship shapes) from the
    regions, which are copied there once."""
    blocks = device_array(window_regions, h, w, window_h, window_w, shift_h, shift_w, device=device or "cpu",
                          dtype=torch.int64)
    diff = blocks[:, None, :] - blocks[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0).to(torch.float32)


def window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    h: int,
    w: int,
    splits: int,
    with_shift: bool = False,
) -> torch.Tensor:
    """Single-head window attention over flattened tokens.

    q: (N, L, C); k, v: (N, L, C) or (N, M, L, C) for multi-view cross
    attention (keys/values of the M other views concatenated per window).
    Returns (N, L, C).
    """
    n, l, c = q.shape
    assert l == h * w
    multi = k.ndim == 4
    m = k.shape[1] if multi else 1
    win_h, win_w = h // splits, w // splits

    qi = q.reshape(n, h, w, c)
    ki = k.reshape(n * m, h, w, c)
    vi = v.reshape(n * m, h, w, c)
    mask = None
    if with_shift:
        sh, sw = win_h // 2, win_w // 2
        qi = torch.roll(qi, (-sh, -sw), dims=(1, 2))
        ki = torch.roll(ki, (-sh, -sw), dims=(1, 2))
        vi = torch.roll(vi, (-sh, -sw), dims=(1, 2))
        mask = shifted_window_mask(h, w, win_h, win_w, sh, sw, q.device).to(q.dtype)

    wl = win_h * win_w
    ns = splits * splits
    qw = window_partition(qi, splits).reshape(n, ns, wl, c)
    kw = window_partition(ki, splits).reshape(n, m, ns, wl, c).transpose(1, 2).reshape(n, ns, m * wl, c)
    vw = window_partition(vi, splits).reshape(n, m, ns, wl, c).transpose(1, 2).reshape(n, ns, m * wl, c)

    scores = torch.matmul(qw, kw.transpose(-1, -2)) / (c**0.5)
    if mask is not None:
        if multi:
            # Reference quirk kept for checkpoint parity: for v > 2 the mask is
            # tiled pixel-major over view-major keys (see the JAX module).
            perm = device_array(key_order, m, wl, device=q.device, dtype=torch.int64)
            scores = scores + mask[:, :, perm][None]
        else:
            scores = scores + mask[None]
    attn = torch.softmax(scores, dim=-1)
    out = torch.matmul(attn, vw)
    out = window_merge(out.reshape(n * ns, win_h, win_w, c), splits)
    if with_shift:
        out = torch.roll(out, (sh, sw), dims=(1, 2))
    return out.reshape(n, l, c)
