"""Deformable-attention sampling in plain PyTorch: bilinear gathers, as mmcv
samples (locations in [0, 1], grid_sample align_corners=False, zero padding).

Frozen from the port's plain versions of its sampling kernels; autograd
differentiates them. `deterministic` is accepted for the call sites' sake
and changes nothing here.
"""

from __future__ import annotations

import torch


def _corners(loc01: torch.Tensor, h: int, w: int):
    """loc01 (..., 2) -> flat corner indices (4, ...) int64 (clipped into the
    map), in-map masks (4, ...), and the fractions wx, wy (...).

    px = loc_x * W - 0.5 and floor(px) in float32, as the JAX `_prep` does.
    Corner order: (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)."""
    px = loc01[..., 0] * w - 0.5
    py = loc01[..., 1] * h - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = px - x0
    wy = py - y0
    # Far outside the map every corner is padding; the clamp keeps the
    # integer conversion defined without changing which corners are inside.
    x0i = torch.clamp(x0, -2.0, w + 1.0).to(torch.int64)
    y0i = torch.clamp(y0, -2.0, h + 1.0).to(torch.int64)
    idx, inside = [], []
    for iy, ix in ((y0i, x0i), (y0i, x0i + 1), (y0i + 1, x0i), (y0i + 1, x0i + 1)):
        inside.append((iy >= 0) & (iy < h) & (ix >= 0) & (ix < w))
        idx.append(torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1))
    return torch.stack(idx), torch.stack(inside), wx, wy


def _bilinear_weights(loc01: torch.Tensor, h: int, w: int):
    """loc01 (..., 2) -> flat corner indices (4, ...) int64 and weights (4, ...);
    out-of-range corners get weight 0 (and a clipped, harmless index)."""
    idx, inside, wx, wy = _corners(loc01, h, w)
    weights = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy])
    return idx, torch.where(inside, weights, torch.zeros_like(weights))


def deform_sample_scores_gather(
    scores: torch.Tensor,  # (..., Q, H*W)
    spatial_shape: tuple[int, int],
    loc01: torch.Tensor,  # (..., Q, D, P, 2)
    attn_weights: torch.Tensor,  # (..., Q, D, P)
) -> torch.Tensor:
    """Gather + weights: out[q, d] = sum_p aw * bilinear(scores[q], loc). -> (..., Q, D)."""
    h, w = spatial_shape
    hw = scores.shape[-1]
    flat = scores.reshape(-1, hw)
    idx, wgt = _bilinear_weights(loc01.reshape(flat.shape[0], *loc01.shape[-3:]), h, w)
    rows = torch.arange(flat.shape[0], device=scores.device)[None, :, None, None]
    sampled = flat.reshape(-1)[rows * hw + idx]  # (4, N, D, P)
    aw = attn_weights.reshape(flat.shape[0], *attn_weights.shape[-2:])
    out = torch.sum(sampled * wgt * aw[None], dim=(0, 3))
    return out.reshape(*scores.shape[:-1], loc01.shape[-3])


def deform_sample_vectors_plain(
    value: torch.Tensor,  # (..., H*W, C)
    spatial_shape: tuple[int, int],
    loc01: torch.Tensor,  # (..., Q, P, 2)
    attn_weights: torch.Tensor,  # (..., Q, P)
) -> torch.Tensor:
    """Plain PyTorch version of K7: weighted bilinear sampling of value
    vectors -> (..., Q, C), float32 gathers."""
    h, w = spatial_shape
    hw, c = value.shape[-2:]
    flat = value.reshape(-1, hw, c)
    n = flat.shape[0]
    q, p = attn_weights.shape[-2:]
    idx, wgt = _bilinear_weights(loc01.reshape(n, q, p, 2), h, w)  # (4, N, Q, P)
    rows = torch.arange(n, device=value.device)[None, :, None, None]
    sampled = flat.reshape(-1, c)[rows * hw + idx]  # (4, N, Q, P, C)
    weight = wgt * attn_weights.reshape(n, q, p)[None]
    out = torch.einsum("knqp,knqpc->nqc", weight, sampled)
    return out.reshape(*value.shape[:-2], q, c)


def deform_sample_scores(scores, spatial_shape, loc01, attn_weights, deterministic: bool = False):
    """(..., Q, H*W) score maps sampled at (..., Q, D, P, 2) -> (..., Q, D)."""
    return deform_sample_scores_gather(scores, tuple(spatial_shape), loc01, attn_weights)


def deform_sample_vectors(value, spatial_shape, loc01, attn_weights, deterministic: bool = False):
    """Value maps (..., H*W, C) sampled at (..., Q, P, 2) -> (..., Q, C)."""
    return deform_sample_vectors_plain(value, tuple(spatial_shape), loc01, attn_weights)
