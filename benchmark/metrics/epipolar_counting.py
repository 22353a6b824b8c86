"""The work of pixelSplat's encoder, counted on the benchmark's plain
reference (benchmark/reference/model/epipolar.py), for `mfu.serve` in the
cells that serve it: FlopCounterMode's count (matrix products, convolutions,
attention) plus the epipolar sampler's bilinear reads, which the counter
does not see, from the shapes. Nothing here reads the program."""

from __future__ import annotations

import torch

# One bilinear read of one channel: four corner products, three adds.
BILINEAR_OPS = 7


def sampler_ops(cfg, batch: int, image_shape) -> int:
    """The bilinear reads of the epipolar sampler: every ray of the low grid
    of every view, num_samples points, d_feature channels."""
    et = cfg.epipolar_transformer
    h, w = image_shape
    rays = batch * cfg.num_context_views * (h // et.downscale) * (w // et.downscale)
    return BILINEAR_OPS * rays * et.num_samples * cfg.d_feature


def encoder_flops(encoder, context: dict) -> int:
    """FLOPs of one forward of the reference `encoder` on `context` (image
    (b, v, H, W, 3), intrinsics, extrinsics, near, far)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        encoder(context["image"], context["intrinsics"], context["extrinsics"], context["near"], context["far"])
    b, _, h, w, _ = context["image"].shape
    return int(counter.get_total_flops()) + sampler_ops(encoder.cfg, b, (h, w))
