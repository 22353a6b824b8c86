"""The work a unit needs, counted on the benchmark's own reference, and the
table of peaks it is held against.

Nothing here reads the program: the FLOPs of a request come from
`FlopCounterMode` over the frozen reference encoder at the cell's shapes
(matrix products, convolutions and attention), plus the deformable
sampler's arithmetic counted from the shapes of its calls; the render's
bytes and operations from the Gaussians and cameras of the request. So
the counts stay the same whatever the program later fuses or renames.
"""

from __future__ import annotations

import contextlib

import torch

# NVIDIA H100 SXM data sheet, dense, at the full 700 W: float32 outside the
# tensor cores (the configurations run float32 with TF32 off), HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# One bilinear sample weighted into a sum, per (output value, sampling
# point): four corner products and three adds, one weight product, one add.
SAMPLE_OPS_PER_POINT = 10
# One (pixel, Gaussian) pair that the blend acts on: the offset (2), the
# conic's quadratic form (8), exp, the opacity product and the clamp (3),
# then colour += alpha T c (7) and T *= 1 - alpha (2).
OPS_PER_KEPT_PAIR = 22
FLOAT_BYTES = 4
# A trainable parameter's update: the squared sum of the global norm (2),
# the clip's product (1), Adam's two moments (3 + 4), the bias corrections
# (2), the square root and epsilon (2), the step (2).
OPT_OPS_PER_PARAM = 16
# A backward costs twice its forward, by the usual count, where the
# counter does not see it (the sampler's gathers, the compositor).
FWD_BWD = 3


@contextlib.contextmanager
def counted_sampler(module, tally: list[int]):
    """Inside, calls of the reference's deformable samplers through
    `module` (the reference's model/uv_transformer.py) add their operations
    to tally[0]."""
    scores, vectors = module.deform_sample_scores, module.deform_sample_vectors

    def count_scores(s, hw, loc01, aw, *args, **kwargs):
        out = scores(s, hw, loc01, aw, *args, **kwargs)
        tally[0] += out.numel() * loc01.shape[-2] * SAMPLE_OPS_PER_POINT
        return out

    def count_vectors(v, hw, loc01, aw, *args, **kwargs):
        out = vectors(v, hw, loc01, aw, *args, **kwargs)
        tally[0] += out.numel() * aw.shape[-1] * SAMPLE_OPS_PER_POINT
        return out

    module.deform_sample_scores, module.deform_sample_vectors = count_scores, count_vectors
    try:
        yield
    finally:
        module.deform_sample_scores, module.deform_sample_vectors = scores, vectors


def encoder_flops(encoder, uv_module, context: dict) -> int:
    """FLOPs of one forward of the reference `encoder` on `context` (image,
    intrinsics, extrinsics, near, far): FlopCounterMode's count plus the
    sampler's operations."""
    from torch.utils.flop_counter import FlopCounterMode

    tally = [0]
    with torch.no_grad(), counted_sampler(uv_module, tally), FlopCounterMode(display=False) as counter:
        encoder(context["image"], context["intrinsics"], context["extrinsics"], context["near"], context["far"])
    return int(counter.get_total_flops()) + tally[0]


def render_bytes(num_gaussians: int, sh_coeffs: int, views: int, image_shape) -> int:
    """The bytes a render has to move at the least: every Gaussian's
    parameters (mean 3, covariance 9, harmonics 3 x n, opacity 1) read once
    per view, and every pixel's colour written once."""
    h, w = image_shape
    per_gaussian = 3 + 9 + 3 * sh_coeffs + 1
    return FLOAT_BYTES * views * (num_gaussians * per_gaussian + h * w * 3)


def render_ops(kept_pairs: int) -> int:
    """The operations a render needs: its kept (pixel, Gaussian) pairs."""
    return OPS_PER_KEPT_PAIR * kept_pairs


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over the
    float32 peak and bytes over the memory's bandwidth."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def train_step_flops(encoder, lpips, uv_module, batch: dict, generator, kept_pairs: int) -> int:
    """FLOPs of one training step on `batch`, on the reference: the encoder's
    forward and backward (FlopCounterMode over a forward in training mode
    and the backward of the sum of its Gaussians, which runs every
    backward product the loss's would), LPIPS's forward and its backward to
    the rendered colours, the sampler's and the compositor's operations
    (`kept_pairs` of the batch's views) forward and backward, and the
    optimizer's per trainable parameter."""
    from torch.utils.flop_counter import FlopCounterMode

    params = [p for p in encoder.parameters() if p.requires_grad]
    ctx, tgt = batch["context"], batch["target"]
    tally = [0]
    encoder.train()
    try:
        with counted_sampler(uv_module, tally), FlopCounterMode(display=False) as counter:
            g = encoder(ctx["image"], ctx["intrinsics"], ctx["extrinsics"], ctx["near"], ctx["far"], generator=generator)
            sum(x.sum() for x in g).backward()  # autograd.grad does not run under the counter's module hooks
            target = tgt["image"].reshape(-1, *tgt["image"].shape[-3:])
            pred = target.detach().clone().requires_grad_(True)
            lpips(pred, target).mean().backward()
    finally:
        encoder.eval()
        encoder.zero_grad(set_to_none=True)
    return (int(counter.get_total_flops()) + FWD_BWD * (tally[0] + render_ops(kept_pairs))
            + OPT_OPS_PER_PARAM * sum(p.numel() for p in params))
