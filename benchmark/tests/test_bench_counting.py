"""The counting functions and the reference compositor against hand counts
on tiny scenes."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark.metrics import counting
from benchmark.reference.ops.rasterizer.projection import ProjectedGaussians
from benchmark.reference.render import composite_view


def _proj(mean2d, conic, radius, opacity, rgb, depth):
    n = len(mean2d)
    return ProjectedGaussians(
        mean2d=torch.tensor(mean2d, dtype=torch.float32), depth=torch.tensor(depth, dtype=torch.float32),
        conic=torch.tensor(conic, dtype=torch.float32), radius=torch.tensor(radius, dtype=torch.float32),
        rgb=torch.tensor(rgb, dtype=torch.float32), opacity=torch.tensor(opacity, dtype=torch.float32),
        valid=torch.ones(n, dtype=torch.bool),
    )


def test_kept_pairs_and_colour_of_two_gaussians():
    # In front, a sharp Gaussian on the middle pixel of a 3 x 3 image (its
    # neighbours' alpha 0.9 e^-10 is under 1/255); behind, a flat one over
    # every pixel at alpha 0.5. Kept pairs: 1 + 9.
    proj = _proj([[1.0, 1.0], [1.0, 1.0]], [[20.0, 0.0, 20.0], [1e-6, 0.0, 1e-6]], [1.0, 10.0], [0.9, 0.5],
                 [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], [1.0, 2.0])
    bg = torch.tensor([0.0, 0.0, 1.0])
    color, kept = composite_view(proj, (3, 3), bg, rows=2)
    assert kept == 10
    assert torch.allclose(color[1, 1], torch.tensor([0.9, 0.05, 0.05]), atol=1e-6)
    assert torch.allclose(color[0, 0], torch.tensor([0.0, 0.5, 0.5]), atol=1e-6)


def test_kept_pairs_stop_when_the_pixel_saturates():
    # Five Gaussians at alpha 0.95 on one pixel: the transmittance before
    # each is 1, .05, .0025, 1.25e-4, 6.25e-6; the fifth is under 1e-4.
    proj = _proj([[0.0, 0.0]] * 5, [[1e-6, 0.0, 1e-6]] * 5, [3.0] * 5, [0.95] * 5, [[1.0, 1.0, 1.0]] * 5,
                 [1.0, 2.0, 3.0, 4.0, 5.0])
    _, kept = composite_view(proj, (1, 1), torch.zeros(3))
    assert kept == 4
    assert counting.render_ops(kept) == 4 * counting.OPS_PER_KEPT_PAIR


def test_encoder_flops_count_products_and_sampling():
    def scores(s, hw, loc01, aw, deterministic=False):
        return torch.zeros(*loc01.shape[:-2])

    def vectors(v, hw, loc01, aw, deterministic=False):
        return torch.zeros(*aw.shape[:-1], v.shape[-1])

    uv = types.SimpleNamespace(deform_sample_scores=scores, deform_sample_vectors=vectors)
    linear = torch.nn.Linear(4, 3)

    def encoder(image, *cams):
        uv.deform_sample_scores(None, (2, 2), torch.zeros(1, 2, 3, 4, 2), torch.zeros(1, 2, 3, 4))  # 6 outputs, P = 4
        uv.deform_sample_vectors(torch.zeros(1, 4, 5), (2, 2), torch.zeros(1, 2, 2, 2), torch.zeros(1, 2, 2))  # 10, P = 2
        return linear(image)

    ctx = {"image": torch.zeros(2, 4), "intrinsics": None, "extrinsics": None, "near": None, "far": None}
    flops = counting.encoder_flops(encoder, uv, ctx)
    assert flops == 2 * 2 * 4 * 3 + (6 * 4 + 10 * 2) * counting.SAMPLE_OPS_PER_POINT
    assert uv.deform_sample_scores is scores  # put back


@pytest.mark.parametrize("views", [1, 3])
def test_render_bytes_by_hand(views):
    # 131,072 Gaussians of SH degree 4 (25 coefficients) into 256 x 256 views.
    per_view = 131_072 * (3 + 9 + 75 + 1) + 256 * 256 * 3
    assert counting.render_bytes(131_072, 25, views, (256, 256)) == 4 * views * per_view
