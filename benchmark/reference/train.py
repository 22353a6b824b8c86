"""The plain training step: encoder -> renderer -> MSE + LPIPS -> gradients ->
global-norm clip -> Adam, in float32 PyTorch with autograd throughout.

The semantics of the port's training step (`make_train_step` over
`ClipAdam`, which writes out optax's chain of clip_by_global_norm and adam):
the encoder in training mode (batch statistics in BatchNorm, dropout masks
from the generator handed in), the frozen DAv2 prior and LPIPS, the loss
mse_weight * MSE + lpips_weight * mean LPIPS over every target view, the
gradients of the trainable parameters clipped to a global norm of
`grad_clip` (g * clip / max(norm, clip)), then Adam with b1 0.9, b2 0.999,
eps 1e-8 outside the square root, bias correction by the number of updates
and the learning rate of the count before the update, one leaf at a time.
The learning rate follows optax's cosine one-cycle schedule, or without
`cosine` a linear warm-up from lr / warm_up_steps to lr over warm_up_steps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from .render import composite_view, project_view

B1, B2, EPS = 0.9, 0.999, 1e-8


def schedule(lr: float, max_steps: int, cosine: bool, warm_up_steps: int):
    """The learning rate as step -> rate: one cycle, or a linear warm-up."""
    if cosine:
        return onecycle(lr, max_steps)
    init = lr / warm_up_steps

    def linear(step: int) -> float:
        return init + min(max(step, 0), warm_up_steps) / warm_up_steps * (lr - init)

    return linear


def onecycle(lr: float, max_steps: int, pct_start: float = 0.01):
    """optax.cosine_onecycle_schedule(max_steps + 10, lr, pct_start, 25, 1e4) as step -> rate."""
    transition = max_steps + 10
    init = lr / 25.0
    end = init / 1e4
    boundary = int(pct_start * transition)

    def decay(count: int, steps: int) -> float:
        count = min(max(count, 0), steps)
        return 0.5 * (1.0 + math.cos(math.pi * count / steps))

    def rate(step: int) -> float:
        if step < boundary:
            return init + (lr - init) * (1.0 - decay(step, boundary))
        return lr + (end - lr) * (1.0 - decay(step - boundary, transition - boundary))

    return rate


@dataclass
class Adam:
    count: int = 0
    mu: dict = field(default_factory=dict)
    nu: dict = field(default_factory=dict)


def render(gaussians, cams: dict, image_shape, background) -> torch.Tensor:
    """Colours (b, t, h, w, 3) of a batch's Gaussians in its target cameras, differentiable."""
    out = []
    for e in range(gaussians.means.shape[0]):
        views = []
        for i in range(cams["extrinsics"].shape[1]):
            proj = project_view(gaussians.means[e], gaussians.covariances[e], gaussians.harmonics[e],
                                gaussians.opacities[e], cams["extrinsics"][e, i], cams["intrinsics"][e, i],
                                cams["near"][e, i], image_shape)
            views.append(composite_view(proj, image_shape, background)[0])
        out.append(torch.stack(views))
    return torch.stack(out)


def loss_and_grads(encoder, lpips, batch: dict, step: int, generator, loss_cfg: dict, image_shape, background):
    """(loss, gradients by the trainable parameters' names) of one batch."""
    params = {k: p for k, p in encoder.named_parameters() if p.requires_grad}
    encoder.train()
    try:
        ctx, tgt = batch["context"], batch["target"]
        g = encoder(ctx["image"], ctx["intrinsics"], ctx["extrinsics"], ctx["near"], ctx["far"],
                    global_step=step, generator=generator)
        color = render(g, tgt, image_shape, background)
        target = tgt["image"]
        loss = loss_cfg["mse_weight"] * torch.mean((color - target) ** 2)
        if loss_cfg["lpips_weight"] > 0.0:
            flat_p, flat_t = color.reshape(-1, *color.shape[-3:]), target.reshape(-1, *target.shape[-3:])
            gate = 1.0 if step >= loss_cfg.get("lpips_apply_after_step", 0) else 0.0
            loss = loss + loss_cfg["lpips_weight"] * gate * torch.mean(lpips(flat_p, flat_t))
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    finally:
        encoder.eval()
    return loss.detach(), {k: torch.zeros_like(p) if gr is None else gr for (k, p), gr in zip(params.items(), grads)}


@torch.no_grad()
def clip(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())).float()
    scale = max_norm / torch.clamp(norm, min=max_norm)
    return {k: g * scale for k, g in grads.items()}


@torch.no_grad()
def adam_update(params: dict, grads: dict, state: Adam, lr: float) -> None:
    if not state.mu:
        state.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        state.nu = {k: torch.zeros_like(p) for k, p in params.items()}
    state.count += 1
    for k, p in params.items():
        g = grads[k]
        state.mu[k] = B1 * state.mu[k] + (1.0 - B1) * g
        state.nu[k] = B2 * state.nu[k] + (1.0 - B2) * g * g
        m_hat = state.mu[k] / (1.0 - B1**state.count)
        v_hat = state.nu[k] / (1.0 - B2**state.count)
        p -= lr * m_hat / (torch.sqrt(v_hat) + EPS)
