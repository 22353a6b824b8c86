"""Training losses.

Counterpart of transplat_tpu/loss/losses.py: MSE (weight 1.0), LPIPS (weight
0.05, gated by `lpips_apply_after_step`), optional depth smoothness.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LossCfg:
    mse_weight: float = 1.0
    lpips_weight: float = 0.05
    lpips_apply_after_step: int = 0
    depth_weight: float = 0.0
    depth_sigma_image: float | None = None
    depth_use_second_derivative: bool = False


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared colour error."""
    delta = pred - target
    return torch.mean(delta**2)


def depth_smoothness_loss(
    depth: torch.Tensor,  # (..., h, w)
    image: torch.Tensor,  # (..., h, w, 3)
    sigma_image: float | None = None,
    use_second_derivative: bool = False,
) -> torch.Tensor:
    """Edge-aware smoothness of the log depth."""
    depth = torch.log(depth + 1e-8)
    dx = depth[..., :, 1:] - depth[..., :, :-1]
    dy = depth[..., 1:, :] - depth[..., :-1, :]
    if use_second_derivative:
        dx = dx[..., :, 1:] - dx[..., :, :-1]
        dy = dy[..., 1:, :] - dy[..., :-1, :]
    if sigma_image is not None:
        gx = (image[..., :, 1:, :] - image[..., :, :-1, :]).abs().mean(-1)
        gy = (image[..., 1:, :, :] - image[..., :-1, :, :]).abs().mean(-1)
        if use_second_derivative:
            gx = gx[..., :, 1:]
            gy = gy[..., 1:, :]
        dx = dx * torch.exp(-gx / sigma_image)
        dy = dy * torch.exp(-gy / sigma_image)
    return dx.abs().mean() + dy.abs().mean()


def compute_losses(
    cfg: LossCfg,
    pred_color: torch.Tensor,  # (b, tv, h, w, 3)
    target_color: torch.Tensor,
    global_step: int,
    lpips_fn=None,  # callable (N, h, w, 3), (N, h, w, 3) -> (N,)
    pred_depth: torch.Tensor | None = None,
):
    """Returns (total loss, dict of unweighted components). LPIPS is always
    evaluated and reported when given; it enters the total from step
    `lpips_apply_after_step` on."""
    parts = {"mse": mse_loss(pred_color, target_color)}
    total = cfg.mse_weight * parts["mse"]

    if cfg.lpips_weight > 0.0 and lpips_fn is not None:
        flat_p = pred_color.reshape(-1, *pred_color.shape[-3:])
        flat_t = target_color.reshape(-1, *target_color.shape[-3:])
        parts["lpips"] = torch.mean(lpips_fn(flat_p, flat_t))
        gate = 1.0 if global_step >= cfg.lpips_apply_after_step else 0.0
        total = total + cfg.lpips_weight * gate * parts["lpips"]

    if cfg.depth_weight > 0.0 and pred_depth is not None:
        parts["depth"] = depth_smoothness_loss(
            pred_depth, target_color, cfg.depth_sigma_image, cfg.depth_use_second_derivative
        )
        total = total + cfg.depth_weight * parts["depth"]

    return total, parts
