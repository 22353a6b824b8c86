"""Bilinear sampling / resizing with torch-compatible conventions.

Counterpart of transplat_tpu/ops/interpolate.py, built from the same static
interpolation matrices so both packages resize identically:
  * grid_sample(align_corners=False, padding_mode="zeros")
  * F.interpolate(mode="bilinear", align_corners=True)
  * F.interpolate(mode="bicubic", a=-0.75), with DINOv2's scale_factor quirk
  * nearest-neighbour upsampling
Public functions take the JAX layout (..., H, W, C); `*_nchw` variants take
(..., C, H, W) for the port's convolution stacks.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.constants import device_array


def _gather_2d(values: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """values: (H, W, C); iy/ix: (...,) int64 -> (..., C) with zero padding."""
    h, w, _ = values.shape
    inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    out = values.reshape(h * w, -1)[torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)]
    return torch.where(inb[..., None], out, torch.zeros_like(out))


def grid_sample(values: torch.Tensor, loc01: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """Bilinear sample of values (H, W, C) at loc01 (..., 2) in [0, 1] -> (..., C)."""
    h, w, _ = values.shape
    if align_corners:
        px = loc01[..., 0] * (w - 1)
        py = loc01[..., 1] * (h - 1)
    else:
        px = loc01[..., 0] * w - 0.5
        py = loc01[..., 1] * h - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0)[..., None]
    wy = (py - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    return (
        _gather_2d(values, y0i, x0i) * (1 - wx) * (1 - wy)
        + _gather_2d(values, y0i, x0i + 1) * wx * (1 - wy)
        + _gather_2d(values, y0i + 1, x0i) * (1 - wx) * wy
        + _gather_2d(values, y0i + 1, x0i + 1) * wx * wy
    )


@lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """Static (n_out, n_in) bilinear interpolation matrix."""
    if align_corners:
        pos = np.linspace(0.0, n_in - 1.0, n_out) if n_out > 1 else np.zeros((1,))
    else:
        pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        pos = np.clip(pos, 0.0, n_in - 1.0)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = (pos - i0).astype(np.float32)
    w_mat = np.zeros((n_out, n_in), np.float32)
    w_mat[np.arange(n_out), i0] += 1.0 - frac
    w_mat[np.arange(n_out), i1] += frac
    return w_mat


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    w = np.where(
        at <= 1.0,
        (a + 2.0) * at**3 - (a + 3.0) * at**2 + 1.0,
        np.where(at < 2.0, a * (at**3 - 5.0 * at**2 + 8.0 * at - 4.0), 0.0),
    )
    return w.astype(np.float64)


@lru_cache(maxsize=64)
def _resize_cubic_weights(n_in: int, n_out: int, scale: float | None) -> np.ndarray:
    """(n_out, n_in) torch bicubic matrix (align_corners=False, no antialias);
    with scale_factor given, source positions use that scale, not n_out/n_in."""
    s = (n_out / n_in) if scale is None else scale
    src = (np.arange(n_out, dtype=np.float64) + 0.5) / s - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    w_mat = np.zeros((n_out, n_in), np.float64)
    for tap in range(-1, 3):
        wt = _cubic_kernel(frac - tap)
        idx = np.clip(i0 + tap, 0, n_in - 1)
        np.add.at(w_mat, (np.arange(n_out), idx), wt)
    return w_mat.astype(np.float32)


def resize_bilinear_nchw(x: torch.Tensor, out_shape: tuple[int, int], align_corners: bool = True) -> torch.Tensor:
    """(..., H, W) -> (..., h2, w2), torch F.interpolate bilinear semantics."""
    h, w = x.shape[-2:]
    wh = device_array(_resize_weights, h, out_shape[0], align_corners, device=x.device, dtype=x.dtype)
    ww = device_array(_resize_weights, w, out_shape[1], align_corners, device=x.device, dtype=x.dtype)
    return torch.matmul(torch.matmul(wh, x), ww.transpose(0, 1))


def resize_bilinear(x: torch.Tensor, out_shape: tuple[int, int], align_corners: bool = True) -> torch.Tensor:
    """(..., H, W, C) -> (..., h2, w2, C), torch F.interpolate bilinear semantics."""
    return resize_bilinear_nchw(x.movedim(-1, -3), out_shape, align_corners).movedim(-3, -1)


def resize_bicubic_torch(
    x: torch.Tensor, out_shape: tuple[int, int], scale: tuple[float, float] | None = None
) -> torch.Tensor:
    """(..., H, W, C) -> (..., h2, w2, C), torch bicubic a=-0.75 semantics."""
    h, w = x.shape[-3:-1]
    sh, sw = scale if scale is not None else (None, None)
    wh = device_array(_resize_cubic_weights, h, out_shape[0], sh, device=x.device, dtype=x.dtype)
    ww = device_array(_resize_cubic_weights, w, out_shape[1], sw, device=x.device, dtype=x.dtype)
    y = torch.matmul(torch.matmul(wh, x.movedim(-1, -3)), ww.transpose(0, 1))
    return y.movedim(-3, -1)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(..., H, W, C) -> (..., H*f, W*f, C), nearest neighbour."""
    return x.repeat_interleave(factor, dim=-3).repeat_interleave(factor, dim=-2)


def upsample_nearest_nchw(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(..., H, W) -> (..., H*f, W*f), nearest neighbour."""
    return x.repeat_interleave(factor, dim=-2).repeat_interleave(factor, dim=-1)
