"""Workload analysis (the fork's research layer) on tensors.

Counterpart of transplat_tpu/utils/analysis.py, computed where the tensors
live (the card on the main path) and returned as plain numbers:
  * Gaussian contribution from the rasterizer's radii and an opacity floor;
  * redundancy: the share of pixel-adjacent Gaussians at nearly one depth;
  * depth-PDF sharpness and entropy;
  * whether feature-similar pixel pairs agree in depth. Its pairs are drawn
    with numpy's default_rng(seed), as the JAX package draws them, so both
    packages score the same pairs.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gaussian_contribution_stats(radii: torch.Tensor, opacities: torch.Tensor, opacity_threshold: float = 0.01) -> dict:
    """radii: (..., G) screen radii; opacities: (..., G)."""
    total = radii.numel()
    visible = radii > 0
    high = visible & (opacities >= opacity_threshold)
    n_visible, n_high = int(visible.sum()), int(high.sum())
    return {
        "total_gaussians": int(total),
        "visible_gaussians": n_visible,
        "high_contribution_gaussians": n_high,
        "visible_ratio": n_visible / total,
        "high_contribution_ratio": n_high / total,
        "opacity_threshold": opacity_threshold,
    }


def adjacent_gaussian_similarity(depths: torch.Tensor, opacities=None, threshold: float = 0.05) -> dict:
    """Share of horizontally / vertically adjacent per-pixel Gaussians whose
    relative depth difference is below `threshold`. depths: (b, v, h, w);
    `opacities` is accepted as the JAX function accepts it, and unused."""
    d = depths
    dx = torch.abs(d[..., :, 1:] - d[..., :, :-1]) / torch.clamp(d[..., :, :-1], min=1e-6)
    dy = torch.abs(d[..., 1:, :] - d[..., :-1, :]) / torch.clamp(d[..., :-1, :], min=1e-6)
    sim_x = float(torch.count_nonzero(dx < threshold)) / dx.numel()
    sim_y = float(torch.count_nonzero(dy < threshold)) / dy.numel()
    return {
        "similar_ratio_x": sim_x,
        "similar_ratio_y": sim_y,
        "similar_ratio": (sim_x + sim_y) / 2,
        "threshold": threshold,
    }


def depth_pdf_stats(pdf: torch.Tensor) -> dict:
    """pdf: (b, v, h, w, D) softmax depth distributions."""
    entropy = -(pdf * torch.log(pdf + 1e-12)).sum(-1)
    max_p = pdf.max(-1).values
    d = pdf.shape[-1]
    mean_entropy = float(entropy.mean())
    return {
        "mean_entropy": mean_entropy,
        "max_entropy": math.log(d),
        "normalized_entropy": mean_entropy / math.log(d),
        "mean_peak_probability": float(max_p.mean()),
        "sharp_fraction": float(torch.count_nonzero(max_p > 0.5)) / max_p.numel(),
    }


def feature_depth_correlation(features: torch.Tensor, depths: torch.Tensor, num_pairs: int = 4096, seed: int = 0) -> dict:
    """Do feature-similar pixel pairs have consistent depth?

    features: (b, v, hf, wf, c); depths: (b, v, h, w), strided down to (hf, wf)."""
    b, v, hf, wf, c = features.shape
    stride_h = depths.shape[2] // hf
    stride_w = depths.shape[3] // wf
    d_small = depths[:, :, ::stride_h, ::stride_w][:, :, :hf, :wf]

    f_flat = features.reshape(-1, c)
    d_flat = d_small.reshape(-1)
    rng = np.random.default_rng(seed)
    i = torch.from_numpy(rng.integers(len(f_flat), size=num_pairs)).to(features.device)
    j = torch.from_numpy(rng.integers(len(f_flat), size=num_pairs)).to(features.device)
    fi = f_flat[i] / (torch.linalg.norm(f_flat[i], dim=-1, keepdim=True) + 1e-8)
    fj = f_flat[j] / (torch.linalg.norm(f_flat[j], dim=-1, keepdim=True) + 1e-8)
    cos = (fi * fj).sum(-1)
    depth_consistent = torch.abs(d_flat[i] - d_flat[j]) / torch.clamp(d_flat[i], min=1e-6) < 0.1
    similar = cos >= 0.7
    n_similar = int(similar.sum())
    return {
        "similar_pair_fraction": n_similar / num_pairs,
        "depth_consistency_given_similar": (
            float(torch.count_nonzero(depth_consistent & similar)) / n_similar if n_similar else 0.0
        ),
        "depth_consistency_overall": float(torch.count_nonzero(depth_consistent)) / num_pairs,
    }
