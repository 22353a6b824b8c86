"""The render's projection routes on the CPU (ops/rasterizer/projection.py).

The plain route (`project_rows_plain`) packs what `project_views` +
`sort_by_depth` give, over SH degrees 0-4, scale invariance on and off, one
or three cameras a Gaussian set, off-centre intrinsics and Gaussians behind
the camera or with det <= 0 on screen; `render` takes the kernel only for
float32 CUDA inputs with no gradient recorded and counts each route; the
kernel's wrapper refuses what it cannot take before any launch. The kernel
itself is held to the plain route on the card (tests/test_torch_cuda.py).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import project_case
from transplat_tpu_torch import kernels
from transplat_tpu_torch.ops.rasterizer import api, binning, projection
from transplat_tpu_torch.ops.rasterizer.projection import (
    pack_rows,
    project_rows_kernel,
    project_rows_plain,
    project_views,
    projection_kernel_applies,
    repeat_sets,
)
from transplat_tpu_torch.utils import trace

SHAPE = (24, 32)
CPU = torch.device("cpu")


def _case(sets, views, degree, seed, g=600):
    return project_case(CPU, sets, views, g, degree, seed)


@pytest.mark.parametrize("sets,views", [(1, 1), (1, 3), (3, 1)])
@pytest.mark.parametrize("scale_invariant", [True, False])
@pytest.mark.parametrize("degree", range(5))
def test_plain_route_packs_what_the_sort_reads(degree, scale_invariant, sets, views):
    """Sorted by their keys, the plain route's rows and colours are
    sort_by_depth's of project_views on every camera's repeated set, and its
    radii RenderOutput's; dead rows carry +inf keys, their means at 1e9,
    radius and opacity 0."""
    extr, intr, near, *gs = _case(sets, views, degree, 17 * degree + 3 * sets + views)
    keys, rows, colors, radii = project_rows_plain(extr, intr, near, *gs, SHAPE, scale_invariant)
    proj = project_views(extr, intr, near, *(repeat_sets(x, views) for x in gs), SHAPE, scale_invariant)
    gfeat, sorted_colors = binning.sort_by_depth(proj)
    got_feat, got_colors = binning.sort_rows(keys, rows, colors)
    assert torch.equal(got_feat, gfeat) and torch.equal(got_colors, sorted_colors)
    assert torch.equal(radii, torch.where(proj.valid, proj.radius, torch.zeros_like(proj.radius)))
    cams, g = sets * views, gs[0].shape[1]
    assert keys.shape == (cams, g) and rows.shape == (cams, g, 8) and colors.shape == (cams, g, 3)
    live = torch.isfinite(keys)
    assert 0 < int(live.sum()) < live.numel()
    dead = rows[~live]
    assert bool((dead[:, 0] == 1e9).all() and (dead[:, 1] == 1e9).all())
    assert bool((dead[:, 5] == 0).all() and (dead[:, 6] == 0).all() and (rows[..., 7] == 0).all())
    assert bool((rows[live][:, 5] > 0).all()) and bool((colors >= 0).all())


def test_the_cases_hold_gaussians_behind_the_camera_and_with_no_positive_det():
    """project_case puts Gaussians behind their first camera (culled at z <=
    0.2) and some whose screen covariance has det <= 0 (culled too, radius
    0), and both kinds come out dead in the plain route's keys."""
    extr, intr, near, *gs = _case(1, 1, 2, 5, g=2000)
    proj = project_views(extr, intr, near, *gs, SHAPE)
    behind = proj.depth <= 0.2
    keys, _ = pack_rows(proj)
    assert int(behind.sum()) >= 150 and bool(torch.isinf(keys[behind]).all())
    front_invalid = ~proj.valid & ~behind
    assert int(front_invalid.sum()) > 0 and bool(torch.isinf(keys[front_invalid]).all())


def test_off_centre_intrinsics_shift_the_rows():
    """The plain route reads the principal point and skew through get_fov's
    rays and K's inverse: moving the principal point moves the means."""
    extr, intr, near, *gs = _case(1, 1, 1, 9)
    centred = intr.clone()
    centred[:, 0, 2] = centred[:, 1, 2] = 0.5
    centred[:, 0, 1] = 0.0
    _, rows_off, _, _ = project_rows_plain(extr, intr, near, *gs, SHAPE)
    _, rows_mid, _, _ = project_rows_plain(extr, centred, near, *gs, SHAPE)
    assert not torch.equal(rows_off[..., :2], rows_mid[..., :2])


def test_render_renders_sets_as_their_repeated_gaussians():
    """render with b sets of Gaussians for b * views cameras equals render
    with each set repeated for its cameras, colours and radii."""
    extr, intr, near, *gs = _case(2, 3, 2, 4, g=300)
    far, bg = torch.full_like(near, 100.0), torch.rand(6, 3, generator=torch.Generator().manual_seed(0))
    a = api.render(extr, intr, near, far, SHAPE, bg, *gs)
    b = api.render(extr, intr, near, far, SHAPE, bg, *(repeat_sets(x, 3) for x in gs))
    assert torch.equal(a.color, b.color) and torch.equal(a.radii, b.radii)
    with pytest.raises(ValueError, match="divide"):
        api.render(extr[:5], intr[:5], near[:5], far[:5], SHAPE, bg[:5], *gs)


def _stub(cuda=True, dtype=torch.float32, grad=False, shape=(1, 4, 3, 25)):
    return SimpleNamespace(is_cuda=cuda, dtype=dtype, requires_grad=grad, shape=shape, ndim=len(shape))


@pytest.mark.parametrize(
    "tensors,sh,grad,takes",
    [
        ((_stub(), _stub()), _stub(), True, True),  # float32 on the card, nothing requires grad
        ((_stub(), None), _stub(), True, True),  # a feature not given
        ((_stub(cuda=False), _stub()), _stub(), True, False),  # the CPU
        ((_stub(), _stub(dtype=torch.float64)), _stub(), True, False),  # float64
        ((_stub(), _stub(dtype=torch.bfloat16)), _stub(), False, False),
        ((_stub(grad=True), _stub()), _stub(), True, False),  # autograd records
        ((_stub(grad=True), _stub()), _stub(), False, True),  # a leaf under no_grad
        ((_stub(), _stub()), _stub(grad=True), True, False),
        ((_stub(), _stub()), _stub(shape=(1, 4, 3, 7)), True, False),  # no SH degree
        ((_stub(), _stub()), _stub(shape=(1, 4, 3, 36)), True, False),  # degree 5
        ((_stub(), _stub()), _stub(shape=(1, 4, 3, 1)), True, True),  # degree 0
    ],
)
def test_the_kernel_route_is_decided_by_device_dtype_gradient_and_degree(tensors, sh, grad, takes):
    with torch.set_grad_enabled(grad):
        assert projection_kernel_applies(*tensors, sh=sh) is takes


def test_render_counts_its_route_and_takes_the_kernel_only_where_it_applies(monkeypatch):
    """On the CPU render takes the plain chain (render.project.plain) and
    launches nothing. Where the route applies, render launches the kernel's
    wrapper once (here the plain route stands in for it, as the kernel
    computes the same rows) and counts render.project.fused, with colours,
    radii and a feature override as the plain chain's."""
    extr, intr, near, *gs = _case(1, 3, 3, 21, g=400)
    far, bg = torch.full_like(near, 100.0), torch.zeros(3, 3)
    trace.reset_counters()
    kernels.reset_launches()
    with torch.no_grad():
        plain = api.render(extr, intr, near, far, SHAPE, bg, *gs)
        plain_depth = api.render_depth(extr, intr, near, far, SHAPE, gs[0], gs[1], gs[3])
    assert trace.counters()["render.project.plain"] == 2 and "render.project.fused" not in trace.counters()
    assert kernels.launches == {}
    calls = []

    def kernel_stand_in(*args, **kw):
        calls.append(kw.get("with_color", True))
        return project_rows_plain(*args, **kw)

    monkeypatch.setattr(api, "projection_kernel_applies", lambda *t, sh: True)
    monkeypatch.setattr(api, "project_rows_kernel", kernel_stand_in)
    trace.reset_counters()
    with torch.no_grad():
        fused = api.render(extr, intr, near, far, SHAPE, bg, *gs)
        fused_depth = api.render_depth(extr, intr, near, far, SHAPE, gs[0], gs[1], gs[3])
        api.render(extr, intr, near, far, SHAPE, bg, *gs, cfg=api.RasterizeConfig(mode="reference"))
    assert calls == [True, False]
    assert trace.counters()["render.project.fused"] == 2 and trace.counters()["render.project.plain"] == 1
    assert torch.equal(fused.color, plain.color) and torch.equal(fused.radii, plain.radii)
    assert torch.equal(fused_depth, plain_depth)


def test_render_under_a_gradient_keeps_the_plain_chain():
    """The plain route stays differentiable: a gradient reaches every
    Gaussian field through the projection."""
    extr, intr, near, *gs = _case(1, 2, 2, 8, g=200)
    leaves = [x.clone().requires_grad_() for x in gs]
    trace.reset_counters()
    out = api.render(extr, intr, near, torch.full_like(near, 100.0), SHAPE, torch.zeros(2, 3), *leaves)
    grads = torch.autograd.grad(out.color.sum(), leaves)
    assert trace.counters()["render.project.plain"] == 1
    assert all(bool(torch.isfinite(x).all()) for x in grads) and float(grads[2].abs().sum()) > 0


def test_the_wrapper_refuses_before_any_launch():
    """project_rows_kernel refuses a wrong dtype, shape, SH count, contiguity,
    camera count, device or a tensor requiring grad, and launches nothing."""
    args = list(_case(1, 2, 2, 3, g=64))
    bad = {
        "float32": (3, args[3].double()),
        "shape": (4, args[4][:, :-1]),
        "SH coefficients": (5, args[5][..., :-2]),
        "contiguous": (3, torch.zeros(1, 64, 4)[..., :3]),
        "CUDA": (6, args[6]),
    }
    kernels.reset_launches()
    for match, (i, t) in bad.items():
        call = list(args)
        call[i] = t
        with pytest.raises(ValueError, match=match):
            project_rows_kernel(*call, SHAPE)
    with pytest.raises(ValueError, match="divide"):
        project_rows_kernel(args[0][:1], args[1][:1], args[2][:1], *(torch.cat([x, x]) for x in args[3:]), SHAPE)
    with pytest.raises(ValueError, match="requires grad"):
        project_rows_kernel(args[0].clone().requires_grad_(), *args[1:], SHAPE)
    assert kernels.launches == {}


def test_decode_fills_its_background_on_the_device_with_no_host_copy(monkeypatch):
    """decode_splatting builds its background with fills (no torch.tensor
    of the colour, which a card would copy from the host), and renders each
    batch entry's Gaussians once for its target views."""
    from transplat_tpu_torch.model import decoder
    from transplat_tpu_torch.model.types import Gaussians

    extr, intr, near, *gs = _case(2, 2, 1, 12, g=200)
    seen = {}

    def fake_render(extr_, intr_, near_, far_, shape, bg, means, *rest, **kw):
        seen.update(bg=bg.clone(), sets=means.shape[0], cams=extr_.shape[0])
        return api.RenderOutput(torch.zeros(extr_.shape[0], *shape, 3), torch.zeros(extr_.shape[0], means.shape[1]),
                                torch.zeros(extr_.shape[0], dtype=torch.int32))

    monkeypatch.setattr(decoder, "render", fake_render)
    monkeypatch.setattr(torch, "tensor", lambda *a, **k: pytest.fail("torch.tensor in decode_splatting"))
    cfg = decoder.DecoderCfg(background_color=(0.25, 0.5, 1.0))
    decoder.decode_splatting(Gaussians(*gs), extr.reshape(2, 2, 4, 4), intr.reshape(2, 2, 3, 3), near.reshape(2, 2),
                             torch.full((2, 2), 100.0), SHAPE, cfg=cfg)
    assert seen["sets"] == 2 and seen["cams"] == 4
    assert torch.equal(seen["bg"], torch.as_tensor(np.tile([0.25, 0.5, 1.0], (4, 1)), dtype=torch.float32))


def test_views_per_set_and_repeat_sets():
    assert projection.views_per_set(6, 2) == 3 and projection.views_per_set(4, 4) == 1
    with pytest.raises(ValueError, match="divide"):
        projection.views_per_set(5, 2)
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(repeat_sets(x, 2), torch.tensor([[0.0, 1, 2], [0, 1, 2], [3, 4, 5], [3, 4, 5]]))
    assert repeat_sets(x, 1) is x
