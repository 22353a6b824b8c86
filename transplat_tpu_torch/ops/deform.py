"""Deformable-attention sampling primitives.

Counterpart of transplat_tpu/ops/deform.py. Sampling conventions are mmcv's:
locations in [0, 1], grid_sample align_corners=False, zero padding.

  * deform_sample_scores — sums of attention-weighted bilinear samples of a
    per-query score map S = K V^T (UVCoarse / UVCross). For CUDA tensors it
    launches the hand-written kernel (K5, csrc/deform_scores.cu); for CPU
    tensors it runs the plain version, the gather oracle.
  * deform_sample_vectors — classic deformable attention over value vectors
    (UVSelf), plain PyTorch in float32 (the JAX default is XLA, not Pallas).

Every function takes any number of leading batch dims (the directed view
pairs of the depth predictor).
"""

from __future__ import annotations

import torch

from .. import kernels


def _bilinear_weights(loc01: torch.Tensor, h: int, w: int):
    """loc01 (..., 2) -> flat corner indices (4, ...) int64 and weights (4, ...).

    px = loc_x * W - 0.5 and floor(px) in float32, as the JAX `_prep` does;
    out-of-range corners get weight 0 (and a clipped, harmless index)."""
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

    def corner(iy, ix, weight):
        inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        idx = torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)
        return idx, torch.where(inb, weight, torch.zeros_like(weight))

    corners = [
        corner(y0i, x0i, (1 - wx) * (1 - wy)),
        corner(y0i, x0i + 1, wx * (1 - wy)),
        corner(y0i + 1, x0i, (1 - wx) * wy),
        corner(y0i + 1, x0i + 1, wx * wy),
    ]
    return torch.stack([c[0] for c in corners]), torch.stack([c[1] for c in corners])


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


# The plain PyTorch version of K5 is the gather oracle itself.
deform_sample_scores_plain = deform_sample_scores_gather


def deform_sample_scores(
    scores: torch.Tensor,
    spatial_shape: tuple[int, int],
    loc01: torch.Tensor,
    attn_weights: torch.Tensor,
) -> torch.Tensor:
    """K5: (..., Q, H*W) score maps sampled at (..., Q, D, P, 2) -> (..., Q, D)."""
    if not scores.is_cuda:
        return deform_sample_scores_plain(scores, spatial_shape, loc01, attn_weights)
    h, w = spatial_shape
    *lead, q, hw = scores.shape
    d, p = loc01.shape[-3], loc01.shape[-2]
    if hw != h * w:
        raise ValueError(f"scores: last dim {hw} != {h} * {w}")
    if tuple(loc01.shape) != (*lead, q, d, p, 2) or tuple(attn_weights.shape) != (*lead, q, d, p):
        raise ValueError(
            f"shapes disagree: scores {tuple(scores.shape)}, loc {tuple(loc01.shape)}, "
            f"weights {tuple(attn_weights.shape)}"
        )
    scores, loc01, attn_weights = (t.contiguous() for t in (scores, loc01, attn_weights))
    for name, t in (("scores", scores), ("loc01", loc01), ("attn_weights", attn_weights)):
        kernels.check_cuda_tensor(name, t, torch.float32)
    out = torch.empty((*lead, q, d), dtype=torch.float32, device=scores.device)
    n = out.numel() // d if d else 0
    kernels.call(
        "tp_deform_scores", f"deform_scores_p{p}",
        scores.data_ptr(), loc01.data_ptr(), attn_weights.data_ptr(), out.data_ptr(),
        n, h, w, d, p,
    )
    return out


def deform_sample_vectors(
    value: torch.Tensor,  # (..., H*W, C)
    spatial_shape: tuple[int, int],
    loc01: torch.Tensor,  # (..., Q, P, 2)
    attn_weights: torch.Tensor,  # (..., Q, P)
) -> torch.Tensor:
    """Weighted bilinear sampling of value vectors -> (..., Q, C), float32 gathers."""
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
