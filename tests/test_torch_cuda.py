"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one:
a CUDA kernel has no CPU mode. The file imports nothing of JAX, so it runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import require_composite
from chip_smoke import synthetic_scene as scene
from transplat_tpu_torch import kernels
from transplat_tpu_torch.ops import deform
from transplat_tpu_torch.ops.rasterizer import api, binning, composite
from transplat_tpu_torch.ops.rasterizer.api import RasterizeConfig

pytestmark = pytest.mark.cuda

# Kernel and plain version do the same float32 arithmetic, the plain version
# in another summation order (cumprod per chunk, sums over corners): 1e-5.
ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _deform_case(q, d, p, h, w, seed, dev):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((q, h * w)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (q, d, p, 2)).astype(np.float32)
    loc[:, : d // 4] = np.round(loc[:, : d // 4] * w) / w  # exact corner boundaries
    aw = rng.random((q, d, p)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (scores, loc, aw)]


@pytest.mark.parametrize(
    "q,d,p,h,w", [(4096, 128, 4, 64, 64), (4096, 128, 1, 64, 64), (37, 5, 3, 7, 11), (8, 4, 2, 160, 160)]
)
def test_deform_scores(dev, q, d, p, h, w):
    scores, loc, aw = _deform_case(q, d, p, h, w, q + d, dev)
    out = deform.deform_sample_scores(scores, (h, w), loc, aw)
    ref = deform.deform_sample_scores_plain(scores, (h, w), loc, aw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL)


@pytest.mark.parametrize("image_shape", [(64, 80), (100, 76)])
def test_binning_kernels_equal_plain(dev, image_shape):
    """K1's three kernels (count, scan, place) each equal to their plain
    versions, and the lists equal to the classic route's (a key per pair,
    torch.sort), bit for bit."""
    cams, gs = scene(3000, 3, dev, 1)
    proj = api.project_views(*cams[:2], cams[2], *gs, image_shape)
    gfeat, _ = binning.sort_by_depth(proj)
    ntx, nty = binning.grid_size(image_shape, 16)
    kernels.reset_launches()
    table, rects, aux = binning.bin_count(gfeat, ntx, nty, 16)
    table_p, rects_p, aux_p = binning.bin_count_plain(gfeat, ntx, nty, 16)
    assert torch.equal(table, table_p) and torch.equal(rects, rects_p)
    bases, bases_p = table.clone(), table.clone()
    ranges = binning.bin_scan(bases, aux)
    ranges_p = binning.bin_scan_plain(bases_p, aux_p)
    assert torch.equal(bases, bases_p) and torch.equal(ranges, ranges_p) and int(aux[0]) == int(aux_p[0])
    total = int(aux[0])
    idx = binning.bin_place(rects, bases, ranges, total, ntx, nty)
    assert torch.equal(idx, binning.bin_place_plain(rects, bases, ranges, total, ntx, nty))
    assert kernels.launches == {"bin_count": 1, "bin_scan": 1, "bin_place": 1}
    ref = binning.bin_gaussians_plain(gfeat, image_shape)
    assert torch.equal(idx, ref.idx) and torch.equal(ranges, ref.ranges)


def _binning_case(dev, case):
    """Depth-sorted rows for the K1 edge cases: a grid wider than one
    shared-memory histogram, a dead-heavy and an all-dead view, Gaussians
    covering every tile, a count that is not a multiple of the chunk, no
    pairs at all."""
    g = 2 * binning.BIN_CHUNK + 37
    shape, tile = ((512, 768), 8) if case == "wide_grid" else ((100, 76), 16)
    cams, gs = scene(g, 3, dev, 5)
    gfeat, _ = binning.sort_by_depth(api.project_views(*cams[:2], cams[2], *gs, shape))
    gfeat = gfeat.clone()
    if case == "dead_views":
        gfeat[1] = torch.tensor([1e9, 1e9, 0, 0, 0, 0, 0, 0], device=dev)
        gfeat[2, ::3] = torch.tensor([1e9, 1e9, 0, 0, 0, 0, 0, 0], device=dev)
    elif case == "cover_all":
        gfeat[:, :5, 2:7] = torch.tensor([1e-8, 0.0, 1e-8, 1e4, 0.9], device=dev)
    elif case == "no_pairs":
        gfeat[..., 5] = 0.0
    return gfeat.contiguous(), shape, tile


@pytest.mark.parametrize("case", ["wide_grid", "dead_views", "cover_all", "ragged", "no_pairs"])
def test_bin_gaussians_equals_the_sorted_route(dev, case):
    gfeat, shape, tile = _binning_case(dev, case)
    lists = binning.bin_gaussians(gfeat, shape, tile)
    ref = binning.bin_gaussians_plain(gfeat, shape, tile)
    torch.cuda.synchronize()
    assert torch.equal(lists.idx, ref.idx) and torch.equal(lists.ranges, ref.ranges)
    assert (lists.num_tiles_x, lists.num_tiles_y) == (ref.num_tiles_x, ref.num_tiles_y)
    if case == "wide_grid":
        assert lists.num_tiles_x * lists.num_tiles_y > 1024  # more tiles than one histogram holds
    if case == "no_pairs":
        assert lists.idx.numel() == 0 and int(lists.ranges.abs().sum()) == 0


@pytest.mark.parametrize("image_shape", [(64, 80), (100, 76)])
def test_render_kernels_match_plain(dev, image_shape):
    cams, gs = scene(3000, 3, dev, 2)
    bg = torch.tensor([[0.2, 0.5, 0.9], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], device=dev)
    kernels.reset_launches()
    out = api.render(*cams, image_shape, bg, *gs)
    assert {"bin_count", "bin_scan", "bin_place", "composite"} <= set(kernels.launches)
    # The plain compositor on the same lists (the binning kernels equal their
    # plain versions exactly, test above), and the naive oracle.
    gfeat, colors = binning.sort_by_depth(api.project_views(*cams[:2], cams[2], *gs, image_shape))
    lists = binning.bin_gaussians(gfeat, image_shape)
    plain, _, _ = composite.composite_tiles_plain(gfeat, colors, lists, bg, image_shape)
    ref = api.render(*cams, image_shape, bg, *gs, cfg=RasterizeConfig(mode="reference"))
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.color.cpu().numpy(), plain.cpu().numpy(), atol=ATOL)
    np.testing.assert_allclose(out.color.cpu().numpy(), ref.color.cpu().numpy(), atol=ATOL)
    depth = api.render_depth(*cams, image_shape, gs[0], gs[1], gs[3])
    depth_ref = api.render_depth(*cams, image_shape, gs[0], gs[1], gs[3], cfg=RasterizeConfig(mode="reference"))
    # Depth features reach ~8: relative 2e-6 on top of the absolute bound.
    np.testing.assert_allclose(depth.cpu().numpy(), depth_ref.cpu().numpy(), atol=ATOL, rtol=2e-6)


# Gradients are compared on values scaled by the gradient's largest entry.
# K6 and K2 (sorted mode) repeat their plain versions' sums in another order:
# 1e-5. K4 sums 256 pixels per entry in another order than the plain
# version's chunked cumsum, and its 1 / (1 - alpha) reaches 100: 1e-4.
GRAD_RTOL = {"deform": 1e-5, "bin": 1e-5, "composite": 1e-4}


def _scaled_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize(
    "q,d,p,h,w", [(4096, 128, 4, 64, 64), (4096, 128, 1, 64, 64), (37, 5, 3, 7, 11), (8, 4, 2, 160, 160)]
)
def test_deform_scores_bwd(dev, q, d, p, h, w):
    """K6 against its plain version and against autograd of the forward's plain version."""
    scores, loc, aw = _deform_case(q, d, p, h, w, q + d, dev)
    gbar = torch.from_numpy(np.random.default_rng(q).standard_normal((q, d)).astype(np.float32)).to(dev)
    kernels.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (scores, loc, aw)]
    out = deform.deform_sample_scores(leaves[0], (h, w), leaves[1], leaves[2])
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, gbar)
    assert kernels.launches.get(f"deform_scores_bwd_p{p}") == 1
    plain = deform.deform_sample_scores_bwd_plain(scores, (h, w), loc, aw, gbar)
    leaves = [t.clone().requires_grad_(True) for t in (scores, loc, aw)]
    auto = torch.autograd.grad(deform.deform_sample_scores_plain(leaves[0], (h, w), leaves[1], leaves[2]), leaves, gbar)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("scores", "loc", "weights"), got, plain, auto):
        assert _scaled_err(a, b) <= GRAD_RTOL["deform"], (name, "plain", _scaled_err(a, b))
        assert _scaled_err(a, c) <= GRAD_RTOL["deform"], (name, "autograd", _scaled_err(a, c))


def _vectors_case(n, q, p, h, w, c, seed, dev):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((n, h * w, c)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (n, q, p, 2)).astype(np.float32)
    loc[:, : q // 4] = np.round(loc[:, : q // 4] * w) / w  # exact corner boundaries
    loc[:, q // 4 : q // 4 + 2] *= 1e7  # far outside the map
    aw = rng.random((n, q, p)).astype(np.float32)
    gbar = rng.standard_normal((n, q, c)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (value, loc, aw, gbar)]


VECTOR_SHAPES = [(2, 4096, 4, 64, 64, 128), (1, 37, 3, 7, 11, 16), (3, 20, 11, 5, 9, 6), (1, 64, 1, 8, 8, 260)]


@pytest.mark.parametrize("n,q,p,h,w,c", VECTOR_SHAPES)
def test_deform_vectors(dev, n, q, p, h, w, c):
    """K7 against its plain version: float4 and scalar channel paths, more than 8 points, any map."""
    value, loc, aw, _ = _vectors_case(n, q, p, h, w, c, q + c, dev)
    kernels.reset_launches()
    out = deform.deform_sample_vectors(value, (h, w), loc, aw)
    assert kernels.launches.get("deform_vectors") == 1
    ref = deform.deform_sample_vectors_plain(value, (h, w), loc, aw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL)
    # one pair alone (no leading dim), and a non-contiguous value map
    single = deform.deform_sample_vectors(value[0], (h, w), loc[0], aw[0])
    np.testing.assert_allclose(single.cpu().numpy(), ref[0].cpu().numpy(), atol=ATOL)
    strided = value.transpose(-1, -2).contiguous().transpose(-1, -2)
    np.testing.assert_allclose(
        deform.deform_sample_vectors(strided, (h, w), loc, aw).cpu().numpy(), ref.cpu().numpy(), atol=ATOL
    )


@pytest.mark.parametrize("n,q,p,h,w,c", VECTOR_SHAPES)
@pytest.mark.parametrize("deterministic", [False, True])
def test_deform_vectors_bwd(dev, n, q, p, h, w, c, deterministic):
    """K8, atomic and sorted mode, through the Function: against its plain
    version and against autograd of the forward's plain version."""
    value, loc, aw, gbar = _vectors_case(n, q, p, h, w, c, q + c, dev)
    kernels.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (value, loc, aw)]
    out = deform.deform_sample_vectors(leaves[0], (h, w), leaves[1], leaves[2], deterministic=deterministic)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, gbar)
    # The atomic mode, or the sorted mode's three launches (keys, the counting sort's order, sums).
    assert kernels.launches.get("deform_vectors_bwd", 0) == (0 if deterministic else 1)
    for name in ("deform_vectors_bwd_keys", "deform_vectors_bwd_order", "deform_vectors_bwd_sorted"):
        assert kernels.launches.get(name, 0) == (1 if deterministic else 0), name
    plain = deform.deform_sample_vectors_bwd_plain(value, (h, w), loc, aw, gbar)
    leaves = [t.clone().requires_grad_(True) for t in (value, loc, aw)]
    auto = torch.autograd.grad(deform.deform_sample_vectors_plain(leaves[0], (h, w), leaves[1], leaves[2]), leaves, gbar)
    torch.cuda.synchronize()
    for name, a, b, c_ in zip(("value", "loc", "weights"), got, plain, auto):
        assert bool(torch.isfinite(a).all()), name
        assert _scaled_err(a, b) <= GRAD_RTOL["deform"], (name, "plain", _scaled_err(a, b))
        assert _scaled_err(a, c_) <= GRAD_RTOL["deform"], (name, "autograd", _scaled_err(a, c_))
    far = slice(q // 4, q // 4 + 2)  # every corner outside the map: exactly 0
    assert float(got[1][:, far].abs().max()) == 0.0 and float(got[2][:, far].abs().max()) == 0.0
    if deterministic:
        again = deform._vectors_bwd_cuda(value, (h, w), loc, aw, gbar, deterministic=True)
        assert all(torch.equal(a, b) for a, b in zip(got, again))  # same bits on every run


def test_deform_vectors_needs_input_grad_and_rejects_bad_input(dev):
    value, loc, aw, gbar = _vectors_case(1, 16, 2, 4, 4, 8, 0, dev)
    v = value.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(deform.deform_sample_vectors(v, (4, 4), loc, aw), [v], gbar)
    assert g.shape == v.shape
    with pytest.raises(ValueError, match="requires grad"):
        deform._vectors_fwd_cuda(v, (4, 4), loc, aw)
    with pytest.raises(ValueError):
        deform.deform_sample_vectors(value.double(), (4, 4), loc, aw)
    with pytest.raises(ValueError, match="rows"):
        deform.deform_sample_vectors(value, (4, 5), loc, aw)
    with pytest.raises(ValueError, match="shapes disagree"):
        deform.deform_sample_vectors(value, (4, 4), loc[:, :8], aw)


def _raster_case(dev, image_shape, channels, seed=2, g=3000):
    cams, gs = scene(g, 3, dev, seed)
    opac = torch.from_numpy(np.random.default_rng(seed).uniform(0.0, 1.2, (3, g)).astype(np.float32)).to(dev)
    gs = (gs[0], gs[1], gs[2], opac.clamp(0.5 / 255, 0.999))  # capped alphas and saturating tiles
    gfeat, colors = binning.sort_by_depth(api.project_views(*cams[:2], cams[2], *gs, image_shape))
    colors = colors[..., :channels].contiguous()
    lists = binning.bin_gaussians(gfeat, image_shape)
    bg = torch.tensor([[0.2, 0.5, 0.9], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], device=dev)[:, :channels].contiguous()
    return gfeat, colors, lists, bg


@pytest.mark.parametrize("image_shape,channels", [((64, 80), 3), ((100, 76), 3), ((64, 64), 1)])
def test_composite_and_bin_bwd_match_plain(dev, image_shape, channels):
    """K4 and K2 (both modes) against their plain versions; K3's T_final."""
    gfeat, colors, lists, bg = _raster_case(dev, image_shape, channels)
    image, t_final = composite._composite_fwd_cuda(gfeat, colors, lists, bg, image_shape)
    image_p, t_final_p, _ = composite.composite_tiles_plain(gfeat, colors, lists, bg, image_shape)
    np.testing.assert_allclose(image.cpu().numpy(), image_p.cpu().numpy(), atol=ATOL)
    np.testing.assert_allclose(t_final.cpu().numpy(), t_final_p.cpu().numpy(), atol=ATOL)
    assert float(t_final.min()) < 1e-4  # some pixels saturate
    g_out = torch.from_numpy(np.random.default_rng(0).standard_normal(tuple(image.shape)).astype(np.float32)).to(dev)
    d_pair = composite._composite_bwd_cuda(gfeat, colors, lists, bg, image, t_final, g_out)
    d_pair_p = composite.composite_tiles_bwd_plain(gfeat, colors, lists, bg, image_p, t_final_p, g_out)
    torch.cuda.synchronize()
    for lo, hi, name in ((0, 2, "mean"), (2, 5, "conic"), (6, 7, "opacity"), (8, 8 + channels, "colour")):
        err = _scaled_err(d_pair[:, lo:hi], d_pair_p[:, lo:hi])
        assert err <= GRAD_RTOL["composite"], (name, err)
    assert d_pair.shape == d_pair_p.shape == (lists.idx.shape[0], binning.pair_width(channels))
    assert float(d_pair[:, 5].abs().max()) == 0.0 and float(d_pair[:, 7].abs().max()) == 0.0
    assert float(d_pair[:, 8 + channels :].abs().max()) == 0.0  # the colour pad
    again = composite._composite_bwd_cuda(gfeat, colors, lists, bg, image, t_final, g_out)
    assert torch.equal(d_pair, again)  # no atomics in K4
    b, g, _ = gfeat.shape
    ref = binning.bin_bwd_plain(d_pair, lists, b, g, channels)
    for deterministic in (True, False):
        got = binning.bin_bwd(d_pair, lists, b, g, channels, deterministic=deterministic)
        for a, r in zip(got, ref):
            assert a.shape == r.shape and _scaled_err(a, r) <= GRAD_RTOL["bin"], (deterministic, _scaled_err(a, r))
    first = binning.bin_bwd(d_pair, lists, b, g, channels, deterministic=True)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, binning.bin_bwd(d_pair, lists, b, g, channels, deterministic=True)))


def _handmade_case(dev, case, channels):
    """Geometry rows made by hand (not projected) for the compositor's edge
    cases, binned by bin_gaussians; colours random in [0, 1)."""
    rng = np.random.default_rng(len(case) + channels)
    views, image_shape = 1, (16, 16)
    if case == "long_list":  # one tile, 2,000 faint wide entries: > 4 batches, T crosses 1e-4 inside batch 6
        g = 2000
        rows = np.zeros((views, g, 8), np.float32)
        rows[..., :2] = rng.uniform(2.0, 13.0, (views, g, 2))
        rows[..., 2], rows[..., 4], rows[..., 5] = 1e-4, 1e-4, 40.0
        rows[..., 6] = rng.uniform(0.0055, 0.0065, (views, g))
    elif case == "warp_edges":  # integer means and radii: rectangles end on 8x4 footprint edges
        views, image_shape, g = 2, (64, 64), 1500
        rows = np.zeros((views, g, 8), np.float32)
        rows[..., :2] = rng.integers(0, 64, (views, g, 2)) + rng.choice([0.0, 0.5], (views, g, 1))
        rows[..., 5] = rng.integers(1, 8, (views, g))
        rows[..., 2] = rows[..., 4] = 0.5 / rows[..., 5] ** 2
        rows[..., 3] = rng.uniform(-0.2, 0.2, (views, g)) * rows[..., 2]
        rows[..., 6] = rng.uniform(0.3, 0.999, (views, g))
    else:  # "empty": three views, the middle one without Gaussians, a corner of the others empty
        views, image_shape, g = 3, (48, 40), 600
        rows = np.zeros((views, g, 8), np.float32)
        rows[..., :2] = rng.uniform(0.0, 20.0, (views, g, 2))
        rows[..., 2] = rows[..., 4] = 0.05
        rows[..., 5] = 4.0
        rows[..., 6] = rng.uniform(0.1, 0.9, (views, g))
        rows[1, :, 5] = rows[1, :, 6] = 0.0
        rows[1, :, :2] = 1e9
    gfeat = torch.from_numpy(rows).to(dev)
    colors = torch.from_numpy(rng.random((views, g, channels)).astype(np.float32)).to(dev)
    bg = torch.from_numpy(rng.random((views, channels)).astype(np.float32)).to(dev)
    return gfeat, colors, binning.bin_gaussians(gfeat, image_shape), bg, image_shape


def _check_k3_k4(dev, gfeat, colors, lists, bg, image_shape, label):
    """K3 (image, T_final) within require_composite of the plain version; K4
    within 1e-4 of the largest entry, its pad columns 0, the same bits twice;
    both give the same bits with the tiles taken longest list first."""
    c = colors.shape[-1]
    image, t_final = composite._composite_fwd_cuda(gfeat, colors, lists, bg, image_shape)
    image_p, t_final_p, _ = composite.composite_tiles_plain(gfeat, colors, lists, bg, image_shape)
    torch.cuda.synchronize()
    require_composite(image, image_p, f"{label}: image")
    require_composite(t_final, t_final_p, f"{label}: T_final")
    g_out = torch.from_numpy(np.random.default_rng(1).standard_normal(tuple(image.shape)).astype(np.float32)).to(dev)
    d_pair = composite._composite_bwd_cuda(gfeat, colors, lists, bg, image, t_final, g_out)
    d_pair_p = composite.composite_tiles_bwd_plain(gfeat, colors, lists, bg, image_p, t_final_p, g_out)
    again = composite._composite_bwd_cuda(gfeat, colors, lists, bg, image, t_final, g_out)
    torch.cuda.synchronize()
    assert d_pair.shape == d_pair_p.shape == (lists.idx.shape[0], binning.pair_width(c))
    assert bool(torch.isfinite(d_pair).all()) and torch.equal(d_pair, again), label
    for lo, hi, name in ((0, 2, "mean"), (2, 5, "conic"), (6, 7, "opacity"), (8, 8 + c, "colour")):
        if float(d_pair_p[:, lo:hi].abs().max()) > 0:
            assert _scaled_err(d_pair[:, lo:hi], d_pair_p[:, lo:hi]) <= GRAD_RTOL["composite"], (label, name)
        else:
            assert float(d_pair[:, lo:hi].abs().max()) == 0.0, (label, name)
    assert float(d_pair[:, 5].abs().max()) == 0.0 and float(d_pair[:, 7].abs().max()) == 0.0
    assert float(d_pair[:, 8 + c :].abs().sum()) == 0.0
    order = composite.tile_order(lists)
    image_o, t_final_o = composite._composite_fwd_cuda(gfeat, colors, lists, bg, image_shape, order=order)
    d_pair_o = composite._composite_bwd_cuda(gfeat, colors, lists, bg, image, t_final, g_out, order=order)
    assert torch.equal(image_o, image) and torch.equal(t_final_o, t_final) and torch.equal(d_pair_o, d_pair), label
    return image, t_final, d_pair


@pytest.mark.parametrize("case", ["long_list", "warp_edges", "empty"])
@pytest.mark.parametrize("channels", [1, 3, 8])
def test_composite_edge_cases_match_plain(dev, case, channels):
    """K3 and K4 on hand-made lists: a tile of more than 4 batches that
    saturates in the middle of one (K4 writes zero rows for the batches it
    skips), rectangles ending on warp-footprint edges, empty tiles and an
    empty view."""
    gfeat, colors, lists, bg, image_shape = _handmade_case(dev, case, channels)
    lengths = lists.ranges[:, 1] - lists.ranges[:, 0]
    image, t_final, d_pair = _check_k3_k4(dev, gfeat, colors, lists, bg, image_shape, f"{case} C={channels}")
    if case == "long_list":
        assert int(lengths.max()) > 4 * 256
        assert float(t_final.max()) < 1e-4  # saturated ...
        assert float(d_pair[-256:].abs().max()) == 0.0  # ... before the last batch
    if case == "empty":
        assert int(lengths.reshape(3, -1)[1].sum()) == 0 and int((lengths == 0).sum()) > lists.ranges.shape[0] // 3
        assert torch.equal(image[1], bg[1].expand_as(image[1])) and float(t_final[1].min()) == 1.0


@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5, 6, 7, 8])
def test_composite_ragged_image_every_channel_count(dev, channels):
    """K3 and K4 on a projected scene at 190x250 (ragged tiles), C = 1 to 8."""
    image_shape = (190, 250)
    gfeat, colors, lists, bg = _raster_case(dev, image_shape, 3, g=4000)
    colors = torch.from_numpy(np.random.default_rng(channels).random((*colors.shape[:2], channels)).astype(np.float32)).to(dev)
    bg = torch.from_numpy(np.random.default_rng(channels + 9).random((3, channels)).astype(np.float32)).to(dev)
    _check_k3_k4(dev, gfeat, colors, lists, bg, image_shape, f"190x250 C={channels}")


@pytest.mark.parametrize("p", [1, 4])
def test_deform_scores_far_outside_and_unaligned(dev, p):
    """K5 in both modes (P = 1 reads corners directly, P = 4 stages rows):
    locations on exact corner boundaries, around the edge and far outside the
    map, and a location tensor that starts 4 bytes into its storage."""
    q, d, h, w = 300, 64, 32, 32
    scores, loc, aw = _deform_case(q, d, p, h, w, 40 + p, dev)
    loc[:, d - 8 :] *= 1e6  # far outside: every corner is padding
    out = deform.deform_sample_scores(scores, (h, w), loc, aw)
    ref = deform.deform_sample_scores_plain(scores, (h, w), loc, aw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL)
    assert float(out[:, d - 8 :].abs().max()) == 0.0
    storage = torch.zeros(loc.numel() + 1, device=dev)
    shifted = storage[1:].view(loc.shape)
    shifted.copy_(loc)
    assert shifted.data_ptr() % 8 == 4
    assert torch.equal(deform.deform_sample_scores(scores, (h, w), shifted, aw), out)


@pytest.mark.parametrize("channels", [3, 5])
def test_bin_bwd_atomic_edge_cases(dev, channels):
    """K2 against its plain version on hand-made lists: three views, the
    middle one without entries, empty tiles, all-zero gradient rows (entries
    past saturation), rows of 12 and 16 floats; one view alone; no entries.
    The lists are those of hand-made rectangles on a 2 x 2 tile grid (a key
    per pair, a stable sort), which K2's deterministic mode reads its order
    from; the first view's rectangles stay in the upper row of tiles."""
    rng = np.random.default_rng(channels)
    views, g, tiles = 3, 50, 4
    x0, y0 = rng.integers(0, 2, (views, g)), rng.integers(0, 2, (views, g))
    x1, y1 = x0 + rng.integers(0, 2, (views, g)), y0 + rng.integers(0, 2, (views, g))
    y0[0], y1[0] = 0, 0
    rects = np.stack([x0, y0, np.minimum(x1, 1), np.minimum(y1, 1)], -1)
    rects[1] = [0, 0, -1, -1]  # the middle view: no entries
    rects[rng.random((views, g)) < 0.2] = [0, 0, -1, -1]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    def lists_of(r):
        r = torch.from_numpy(r.astype(np.int32))
        keys, vals = binning._pairs_of_rects(r, 2, 2)
        keys_sorted, order = torch.sort(keys, stable=True)
        return binning.TileLists(to(vals[order].to(torch.int32)), to(binning.bin_ranges_plain(keys_sorted, r.shape[0] * tiles)),
                                 2, 2, to(binning.pack_rects(r)))

    lists = lists_of(rects)
    n = lists.idx.shape[0]
    lengths = (lists.ranges[:, 1] - lists.ranges[:, 0]).reshape(views, tiles)
    assert int(lengths[1].sum()) == 0 and int(lengths[0, 2:].sum()) == 0 and n > 0
    d_pair = np.zeros((n, binning.pair_width(channels)), np.float32)
    d_pair[:, [0, 1, 2, 3, 4, 6]] = rng.standard_normal((n, 6))
    d_pair[:, 8 : 8 + channels] = rng.standard_normal((n, channels))
    d_pair[rng.random(n) < 0.3] = 0.0
    cases = [(views, to(d_pair), lists)]
    alone = lists_of(rects[:1])
    cases.append((1, to(d_pair[: alone.idx.shape[0]]), alone))
    empty = lists_of(np.tile(np.array([0, 0, -1, -1]), (1, g, 1)))
    cases.append((1, torch.zeros((0, binning.pair_width(channels)), device=dev), empty))
    for b, dp, lists in cases:
        ref = binning.bin_bwd_plain(dp, lists, b, g, channels)
        for deterministic in (False, True):
            got = binning.bin_bwd(dp, lists, b, g, channels, deterministic=deterministic)
            torch.cuda.synchronize()
            for a, r in zip(got, ref):
                assert a.shape == r.shape and a.shape[-1] in (8, channels)
                if r.numel() and float(r.abs().max()) > 0:
                    assert _scaled_err(a, r) <= GRAD_RTOL["bin"], (b, deterministic, _scaled_err(a, r))
                else:
                    assert float(a.abs().sum()) == 0.0


def test_render_gradients_match_finite_differences(dev):
    """The kernels' renderer gradient against central differences of the
    kernels' own forward, in float32 on a few tiles: a smooth scene (opacity
    0.3-0.6, no capped or floor-level alphas, tiny steps do not flip the
    integer radius), loose tolerance 5% of each gradient's largest entry."""
    image_shape = (32, 48)
    cams, gs = scene(40, 1, dev, 7)
    rng = np.random.default_rng(7)
    means = gs[0].clone()
    means[..., :2] *= 0.3
    cov = gs[1] * 30.0
    opac = torch.from_numpy(rng.uniform(0.3, 0.6, (1, 40)).astype(np.float32)).to(dev)
    weight = torch.from_numpy(rng.standard_normal((1, *image_shape, 3)).astype(np.float32)).to(dev)
    bg = torch.tensor([[0.3, 0.1, 0.6]], device=dev)

    def loss(m, o, s):
        return torch.sum(api.render(*cams, image_shape, bg, m, cov, s, o).color * weight)

    leaves = [t.clone().requires_grad_(True) for t in (means, opac, gs[2])]
    kernels.reset_launches()
    value = loss(*leaves)
    assert value.grad_fn is not None
    grads = torch.autograd.grad(value, leaves)
    assert kernels.launches.get("composite_bwd") == 1 and kernels.launches.get("bin_bwd") == 1
    eps = 1e-3
    for which, (leaf, grad) in enumerate(zip(leaves, grads)):
        flat = leaf.detach().reshape(-1)
        picks = rng.choice(flat.numel(), size=12, replace=False)
        for i in picks:
            args = [t.detach().clone() for t in leaves]
            hi, lo = args[which].reshape(-1).clone(), args[which].reshape(-1).clone()
            hi[i] += eps
            lo[i] -= eps
            args[which] = hi.reshape(leaf.shape)
            up = loss(*args)
            args[which] = lo.reshape(leaf.shape)
            fd = float(up - loss(*args)) / (2 * eps)
            scale = float(grad.abs().max())
            assert abs(fd - float(grad.reshape(-1)[i])) <= 0.05 * scale + 1e-3, (which, int(i), fd, float(grad.reshape(-1)[i]), scale)


def test_composite_tiles_orders_tiles_only_where_a_backward_follows(dev, monkeypatch):
    """A forward alone takes the tiles in cell order (no sort); a recorded
    forward sorts them once, longest list first, and its backward reuses the
    order. Image and gradients are those of the direct launches."""
    image_shape = (64, 80)
    gfeat, colors, lists, bg = _raster_case(dev, image_shape, 3)
    sorts = []
    real = composite.tile_order
    monkeypatch.setattr(composite, "tile_order", lambda l: sorts.append(1) or real(l))
    with torch.no_grad():
        alone = composite.composite_tiles(gfeat, colors, lists, bg, image_shape)
    assert not sorts
    leaves = [t.clone().requires_grad_(True) for t in (gfeat, colors)]
    image = composite.composite_tiles(leaves[0], leaves[1], lists, bg, image_shape)
    assert len(sorts) == 1 and torch.equal(image, alone)
    g_out = torch.from_numpy(np.random.default_rng(4).standard_normal(tuple(image.shape)).astype(np.float32)).to(dev)
    d_gfeat, d_colors = torch.autograd.grad(image, leaves, g_out)
    assert len(sorts) == 1
    _, t_final = composite._composite_fwd_cuda(gfeat, colors, lists, bg, image_shape)
    d_pair = composite._composite_bwd_cuda(gfeat, colors, lists, bg, alone, t_final, g_out)
    b, g, _ = gfeat.shape
    ref_g, ref_c = binning.bin_bwd_plain(d_pair, lists, b, g, 3)
    assert _scaled_err(d_gfeat, ref_g) <= GRAD_RTOL["bin"] and _scaled_err(d_colors, ref_c) <= GRAD_RTOL["bin"]


def test_every_wrapper_keeps_the_graph(dev):
    """A CUDA tensor that requires grad never leaves a wrapper without a grad_fn."""
    scores, loc, aw = (t.requires_grad_(True) for t in _deform_case(16, 8, 2, 8, 8, 0, dev))
    assert deform.deform_sample_scores(scores, (8, 8), loc, aw).grad_fn is not None
    values = torch.randn(64, 8, device=dev, requires_grad=True)
    assert deform.deform_sample_vectors(values, (8, 8), loc[:, 0], aw[:, 0]).grad_fn is not None
    gfeat, colors, lists, bg = _raster_case(dev, (32, 32), 3, g=200)
    for t in (gfeat, colors, bg):
        t.requires_grad_(True)
    assert composite.composite_tiles(gfeat, colors, lists, bg, (32, 32)).grad_fn is not None
    cams, gs = scene(200, 2, dev, 3)
    gs = [t.requires_grad_(True) for t in gs]
    out = api.render(*cams, (32, 32), bg[:2].detach(), *gs)
    assert out.color.grad_fn is not None
    grads = torch.autograd.grad(out.color.sum(), gs)
    assert all(bool(torch.isfinite(x).all()) for x in grads)
    depth = api.render_depth(*cams, (32, 32), gs[0], gs[1], gs[3])
    assert depth.grad_fn is not None
    # The raw launchers refuse what they could only return with the graph cut.
    with pytest.raises(ValueError, match="requires grad"):
        deform._scores_fwd_cuda(scores, (8, 8), loc, aw)
    with pytest.raises(ValueError, match="requires grad"):
        composite._composite_fwd_cuda(gfeat, colors, lists, bg, (32, 32))
    with pytest.raises(ValueError, match="requires grad"):
        binning.bin_count(gfeat, 2, 2, 16)
    with torch.no_grad():
        assert binning.bin_count(gfeat, 2, 2, 16)[0].dtype == torch.int32


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(ValueError):
        deform.deform_sample_scores(
            torch.zeros(4, 16, device=dev, dtype=torch.float64), (4, 4),
            torch.zeros(4, 2, 1, 2, device=dev), torch.zeros(4, 2, 1, device=dev),
        )
    with pytest.raises(ValueError):
        binning.bin_count(torch.zeros(1, 4, 7, device=dev), 2, 2, 16)
    with pytest.raises(ValueError):
        composite.composite_tiles(
            torch.zeros(1, 4, 8, device=dev), torch.zeros(1, 4, 3, device=dev),
            binning.TileLists(torch.zeros(0, dtype=torch.int32, device=dev), torch.zeros(4, 2, dtype=torch.int32, device=dev), 2, 2),
            torch.zeros(1, 3, device=dev), (32, 32), tile=8,
        )


def test_tiny_encoder_card_matches_cpu(dev):
    """The whole slice at a tiny width: kernels on the card vs plain versions
    on the CPU, same random weights."""
    from transplat_tpu_torch.dataset import synthetic_batch
    from transplat_tpu_torch.inference import render_novel_views
    from transplat_tpu_torch.model.adapter import GaussianAdapterCfg
    from transplat_tpu_torch.model.encoder import EncoderCfg, EncoderTranSplat

    cfg = EncoderCfg(
        d_feature=16, num_depth_candidates=16, costvolume_unet_feat_dim=16, costvolume_unet_channel_mult=(1, 1),
        costvolume_unet_attn_res=(2,), depth_unet_feat_dim=8, depth_unet_attn_res=(4,),
        depth_unet_channel_mult=(1, 1, 1), dav2_encoder="vits", dav2_input_size=28,
        gaussian_adapter=GaussianAdapterCfg(sh_degree=1),
    )
    torch.manual_seed(0)
    enc_cpu = EncoderTranSplat(cfg, device="cpu")
    with torch.no_grad():  # keep depths off the 1/far clip (see test_torch_encoder.py)
        enc_cpu.depth_predictor.to_disparity_2.weight[0] *= 0.01
    enc_gpu = EncoderTranSplat(cfg, device="cuda")
    enc_gpu.load_state_dict(enc_cpu.state_dict())
    batch = synthetic_batch(0, image_shape=(64, 64), num_target=2)
    ctx = [batch["context"][k] for k in ("image", "intrinsics", "extrinsics", "near", "far")]
    with torch.no_grad():
        g_gpu = enc_gpu(*(torch.as_tensor(a, device=dev) for a in ctx))
        g_cpu = enc_cpu(*(torch.as_tensor(a) for a in ctx))
    # Two devices run convolutions and matmuls in other orders: 1e-3.
    for a, b in zip(g_gpu, g_cpu):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-3, rtol=1e-3)
    kernels.reset_launches()
    out_gpu = render_novel_views(enc_gpu, batch["context"], batch["target"], (64, 64), device="cuda")
    out_cpu = render_novel_views(enc_cpu, batch["context"], batch["target"], (64, 64), device="cpu")
    assert all(kernels.launches.get(k, 0) > 0 for k in ("deform_scores_p1", "deform_scores_p4", "composite"))
    # The image is a step function of the Gaussians (integer cutoff radius,
    # 1/255 alpha floor; see test_torch_encoder.py): 98% within 1e-4.
    diff = np.abs(out_gpu.cpu().numpy() - out_cpu.numpy())
    assert np.mean(diff > 1e-4) < 0.02 and diff.max() < 0.05, (np.mean(diff > 1e-4), diff.max())


# Repeatable training steps (trainer.deterministic_kernels) and the K6 / K8
# designs that serve them.


@pytest.mark.parametrize(
    "q,d,p,h,w,path",
    [(4096, 128, 4, 64, 64, "staged"), (4096, 128, 1, 64, 64, "direct"), (37, 5, 3, 7, 11, "direct"),
     (4, 4, 2, 256, 256, "general")],
)
def test_deform_scores_bwd_paths_repeat_their_bits(dev, q, d, p, h, w, path):
    """K6 on each of its paths against its plain version; the staged and
    direct paths give the same bits twice and under `deterministic`; the
    general path (a row over the shared-memory budget) refuses
    `deterministic` rather than add with atomics whose order varies."""
    scores, loc, aw = _deform_case(q, d, p, h, w, q + d + 1, dev)
    gbar = torch.from_numpy(np.random.default_rng(q + 1).standard_normal((q, d)).astype(np.float32)).to(dev)
    assert deform.scores_bwd_plan(h, w, d, p) == path
    got = deform._scores_bwd_cuda(scores, (h, w), loc, aw, gbar)
    plain = deform.deform_sample_scores_bwd_plain(scores, (h, w), loc, aw, gbar)
    torch.cuda.synchronize()
    for name, a, b in zip(("scores", "loc", "weights"), got, plain):
        assert _scaled_err(a, b) <= GRAD_RTOL["deform"], (name, _scaled_err(a, b))
    if path == "general":
        with pytest.raises(ValueError, match="deterministic"):
            deform._scores_bwd_cuda(scores, (h, w), loc, aw, gbar, deterministic=True)
    else:
        again = deform._scores_bwd_cuda(scores, (h, w), loc, aw, gbar, deterministic=True)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_deform_scores_bwd_non_finite_query_gives_nan_row(dev):
    """A query whose d out is not finite gets a NaN gradient row; the others are unharmed."""
    q, d, p, h, w = 6, 32, 4, 16, 16
    scores, loc, aw = _deform_case(q, d, p, h, w, 5, dev)
    gbar = torch.randn((q, d), device=dev)
    gbar[2, 3] = float("inf")
    got = deform._scores_bwd_cuda(scores, (h, w), loc, aw, gbar)
    plain = deform.deform_sample_scores_bwd_plain(scores, (h, w), loc, aw, gbar)
    assert bool(torch.isnan(got[0][2]).all())
    keep = [0, 1, 3, 4, 5]
    assert _scaled_err(got[0][keep], plain[0][keep]) <= GRAD_RTOL["deform"]


@pytest.mark.parametrize("shape", [(2, 64, 64, 128, 4), (1, 20, 24, 12, 3), (2, 9, 17, 8, 1)])
@pytest.mark.parametrize("deterministic", [False, True])
def test_deform_vectors_bwd_tiles_and_halo(dev, shape, deterministic):
    """K8 with self-attention-like locations (the queries are the map's
    pixels, so its atomic mode takes 8x8 tiles and their windows): corners
    inside a tile's window, outside it and far outside the map; float4 and
    scalar channels, ragged tiles. Against the plain version; far-outside
    points give exactly 0; the sorted mode repeats its bits."""
    n, h, w, c, p = shape
    rng = np.random.default_rng(h * w + c)
    q = h * w
    ys, xs = np.divmod(np.arange(q), w)
    centres = np.stack([(xs + 0.5) / w, (ys + 0.5) / h], -1)[None, :, None]
    loc = centres + rng.standard_normal((n, q, p, 2)) * (1.5 / w)
    loc[:, : q // 8] = rng.uniform(-0.1, 1.1, (n, q // 8, p, 2))
    loc[:, q // 8 : q // 8 + 3] *= 1e6
    value, aw, gbar = (rng.standard_normal((n, q, c)), rng.random((n, q, p)), rng.standard_normal((n, q, c)))
    value, loc, aw, gbar = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (value, loc, aw, gbar))
    got = deform._vectors_bwd_cuda(value, (h, w), loc, aw, gbar, deterministic=deterministic)
    plain = deform.deform_sample_vectors_bwd_plain(value, (h, w), loc, aw, gbar)
    torch.cuda.synchronize()
    for name, a, b in zip(("value", "loc", "weights"), got, plain):
        assert _scaled_err(a, b) <= GRAD_RTOL["deform"], (name, _scaled_err(a, b))
    far = slice(q // 8, q // 8 + 3)
    assert float(got[1][:, far].abs().max()) == 0.0 and float(got[2][:, far].abs().max()) == 0.0
    if deterministic:
        again = deform._vectors_bwd_cuda(value, (h, w), loc, aw, gbar, deterministic=True)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_two_full_width_steps_with_the_switch_repeat_their_bits(dev):
    """chip_smoke.py's train_deterministic: from one state, two full-width
    re10k training steps with trainer.deterministic_kernels give the same
    loss, gradients, parameters and Adam moments bit for bit, through the
    sorted modes of K2 and K8."""
    from chip_smoke import train_deterministic

    train_deterministic(dev, [])


def test_precision_and_checkpointing_at_a_tiny_width(dev):
    """chip_smoke.py's precision_remat at the tiny width, one step a
    setting: K5 at P = 4 and K7 twice a step, four times under
    remat_matching; float32 at every kernel; the bf16 step near the float32
    step; the checkpointed step bit for bit the plain one under the switch."""
    from chip_smoke import precision_remat
    from transplat_tpu_torch.train_demo import tiny_encoder_cfg

    precision_remat(dev, [], encoder_cfg=tiny_encoder_cfg(), image=(64, 64), steps=1)


def test_fit_resume_with_the_switch_is_exact(dev):
    """chip_smoke.py's fit_resume_deterministic: a Trainer resumed from the
    middle checkpoint repeats the first run's losses and parameters exactly."""
    from chip_smoke import fit_resume_deterministic

    fit_resume_deterministic(dev, [])


def test_jpeg_route_on_the_card_decodes_its_source(dev):
    """The card machine's JPEG route (nvJPEG where the host has no libjpeg):
    frames it encodes at quality 95 decode within chip_smoke.py's tolerance
    of their source pixels, a truncated or foreign stream raises."""
    from chip_smoke import JPEG_MAE_TOL
    from transplat_tpu_torch import native
    from transplat_tpu_torch.dataset import chunks

    route = native.jpeg_route()
    source = chunks.panorama_frames(4, (360, 640), seed=1)
    blobs = native.encode_jpeg_batch(source, quality=95)
    decoded = native.decode_jpeg_batch(blobs)
    assert decoded.shape == source.shape and decoded.dtype == np.uint8
    assert float(np.abs(decoded.astype(np.float64) - source).mean()) / 255.0 <= JPEG_MAE_TOL, route
    assert all(native.jpeg_shape(b) == (360, 640) for b in blobs)
    for bad in (blobs[0][: len(blobs[0]) // 2], b"not a jpeg"):
        with pytest.raises(ValueError):
            native.decode_jpeg_batch([bad])
    if native.has_nvjpeg():
        on_card = native.decode_jpeg_batch(blobs, route="nvjpeg")
        assert float(np.abs(on_card.astype(np.float64) - source).mean()) / 255.0 <= JPEG_MAE_TOL


def test_main_train_two_steps_over_chunks(dev, tmp_path, monkeypatch):
    """`main train` on the card over seeded chunks: a narrow encoder at 64x64,
    two forked loader workers, two steps; a checkpoint, and validations that
    read the test split."""
    import json

    from transplat_tpu_torch.dataset import chunks
    from transplat_tpu_torch.main import main

    data = tmp_path / "data"
    chunks.write_chunk(data / "train" / "000000.torch", [chunks.make_scene(f"tr_{i}", 30, seed=i) for i in range(2)])
    chunks.write_chunk(data / "test" / "000000.torch", [chunks.make_scene("te_0", 60, seed=7)])
    (tmp_path / "tiny.yaml").write_text(
        "dataset: {image_shape: [64, 64]}\n"
        "encoder: {d_feature: 16, num_depth_candidates: 16, costvolume_unet_feat_dim: 16,"
        " costvolume_unet_channel_mult: [1, 1], costvolume_unet_attn_res: [2], depth_unet_feat_dim: 8,"
        " depth_unet_attn_res: [4], depth_unet_channel_mult: [1, 1, 1], dav2_encoder: vits, dav2_input_size: 28,"
        " gaussian_adapter: {sh_degree: 1}}\n"
        "trainer: {batch_size: 1, num_workers: 2, val_check_interval: 0.5}\n"
    )
    monkeypatch.chdir(tmp_path)
    run = tmp_path / "run"
    assert main(["train", "--config", "tiny.yaml", "--dataset-root", str(data), "--max-steps", "2",
                 "--output", str(run)]) == 0
    assert (run / "checkpoints" / "step_00000002.pt").exists()
    vals = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines() if "val_psnr" in x]
    assert [r["step"] for r in vals] == [1, 2] and all(r["val_scenes"] == ["te_0"] for r in vals)


# Evaluation from weight files (the staged encoder, the videos' 30-view decodes).


def _tiny_encoder(dev, seed=0):
    from transplat_tpu_torch.inference import init_random
    from transplat_tpu_torch.model.encoder import EncoderTranSplat
    from transplat_tpu_torch.train_demo import tiny_encoder_cfg

    encoder = EncoderTranSplat(tiny_encoder_cfg(), device=dev)
    init_random(encoder, seed)
    return encoder


def test_staged_encoder_matches_fused_on_the_card(dev):
    """The staged encoder runs the fused encoder's operations stage by stage,
    with a synchronisation and two CUDA events between stages: the same
    Gaussians (STAGED_TOL), every stage timed and measured on the card."""
    from chip_smoke import STAGED_TOL
    from transplat_tpu_torch.dataset import synthetic_batch
    from transplat_tpu_torch.evaluation.staged import STAGES, StagedEncoder
    from transplat_tpu_torch.utils.benchmarker import Benchmarker

    encoder = _tiny_encoder(dev)
    batch = synthetic_batch(0, image_shape=(64, 64), num_target=1)
    ctx = [torch.as_tensor(batch["context"][k], device=dev) for k in ("image", "intrinsics", "extrinsics", "near", "far")]
    kernels.reset_launches()
    with torch.no_grad():
        fused = encoder(*ctx)
    fused_launches = dict(kernels.launches)
    bench = Benchmarker(dev)
    staged = StagedEncoder(encoder)
    kernels.reset_launches()
    gaussians, aux = staged.run(batch["context"], benchmarker=bench)
    assert dict(kernels.launches) == fused_launches  # the same kernels, as often
    for a, b in zip(gaussians, fused):
        err = float(((a - b).abs() / (1.0 + b.abs())).max())
        assert err <= STAGED_TOL, err
    summary = bench.summarize()
    assert list(summary) == STAGES and all(s["mean_ms"] > 0 for s in summary.values())
    memory = staged.memory_analysis()
    assert all(memory[t]["peak_bytes_in_use"] >= memory[t]["bytes_in_use_before"] for t in STAGES)
    assert staged.cost_analysis()["encoder_2_backbone"]["flops"] > 0


def test_thirty_view_decode_matches_plain(dev):
    """A video's decode: 30 target views of one scene in one call, the kernels
    (K1's lists, K3) against the plain compositor on the same lists and the
    classic binning route."""
    cams, gs = scene(20_000, 30, dev, 5)
    image_shape = (256, 256)
    bg = torch.zeros(30, 3, device=dev)
    kernels.reset_launches()
    out = api.render(*cams, image_shape, bg, *gs)
    assert kernels.launches.get("composite", 0) == 1 and kernels.launches.get("bin_place", 0) == 1
    gfeat, colors = binning.sort_by_depth(api.project_views(*cams[:2], cams[2], *gs, image_shape))
    lists = binning.bin_gaussians(gfeat, image_shape)
    classic = binning.bin_gaussians_plain(gfeat, image_shape)
    assert torch.equal(lists.idx, classic.idx) and torch.equal(lists.ranges, classic.ranges)
    assert lists.idx.numel() > 0 and lists.ranges.dtype == torch.int32
    plain, _, _ = composite.composite_tiles_plain(gfeat, colors, lists, bg, image_shape)
    torch.cuda.synchronize()
    require_composite(out.color, plain, "30-view decode")


def test_orthographic_render_on_the_card_matches_the_cpu(dev):
    """visualization/validation_3d.py's render (K1 and K3) at the Trainer's
    looks, ~573x the cloud's extent away: the card against the plain
    versions on the CPU on the same Gaussians (projection rounding may flip
    an integer radius or the 1/255 alpha floor: 98% within 1e-4, all within
    0.05, as tiny_slice_vs_cpu), and launches of K1 and K3."""
    from transplat_tpu_torch.model.types import Gaussians
    from transplat_tpu_torch.visualization.validation_3d import axis_looks, render_orthographic

    cams, gs = scene(6000, 1, dev, 11)
    looks, extent = axis_looks(gs[0][0].cpu().numpy())
    looks_t = torch.as_tensor(np.stack([e for _, e in looks]), dtype=torch.float32)
    g3 = Gaussians(*(x.expand(3, *x.shape[1:]).contiguous() for x in gs))
    kernels.reset_launches()
    card = render_orthographic(g3, looks_t.to(dev), extent, extent, 0.0, 2 * extent, (128, 128))
    assert kernels.launches.get("composite", 0) == 1 and kernels.launches.get("bin_place", 0) == 1
    cpu = render_orthographic(Gaussians(*(x.cpu() for x in g3)), looks_t, extent, extent, 0.0, 2 * extent, (128, 128))
    diff = (card.cpu() - cpu).abs()
    assert float(card.max()) > 0.05
    assert float((diff > 1e-4).float().mean()) < 0.02 and float(diff.max()) < 0.05, float(diff.max())


@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2)])
def test_parallel_step_of_two_ranks_on_the_card_matches_one_process(dev, dp, sp):
    """chip_smoke.py's parallel phase at the tiny width: two gloo ranks
    sharing the card take one step (dp: the joined batch split over the
    ranks, dropout off; sp: the views split, dropout on), held against the
    one-process step on the card; every rank launched K1-K4 in its step, and
    an sp rank's sharded decode equals the unsharded one within 1e-5. The
    step's bounds: sp as tests/test_torch_parallel.py's STEP_TOL; dp a few
    times its readings at this width on an H100 (norm 2.3e-5, gradient
    1.5e-4, worst leaf 1.1e-2, update cosine 1 - 1.4e-4), which round
    further from the joined batch than the CPU's; the loss and BatchNorm
    statistics 1e-5."""
    from chip_smoke import RASTER_KERNELS
    from test_torch_parallel import STEP_TOL
    from transplat_tpu_torch.parallel import dryrun, launch

    card_tol = {"sp": STEP_TOL["sp"], "dp": {**STEP_TOL["dp"], "clipped_grad_rel_l2": 5e-4, "worst_leaf_rel": 5e-2,
                                             "update_cos_min": 1 - 5e-4}}

    spec = dryrun.StepSpec(dp=dp, sp=sp, device="cuda", backend="gloo", dropout=sp > 1, return_params=True,
                           decode_check=True)
    ranks = launch.spawn(dryrun.step_rank, 2, spec, timeout_s=300, local_ranks=False)
    ref = dryrun.reference_step(spec)
    errs = dryrun.step_errors(ranks, ref)
    tol = card_tol["sp" if sp > 1 else "dp"]
    assert errs["finite"] and errs["same_metrics_on_every_rank"] and errs["same_keys"], errs
    assert errs["loss_rel_err"] <= 1e-5 and errs["batch_norm_max_abs_err"] <= 1e-5, errs
    assert errs["grad_norm_rel_err"] <= tol["grad_norm_rtol"], errs
    assert errs["clipped_grad_rel_l2"] <= tol["clipped_grad_rel_l2"], errs
    assert errs["clipped_grad_worst_leaf_rel"] <= tol["worst_leaf_rel"], errs
    assert errs["update_cosine"] >= tol["update_cos_min"] and errs["color_max_abs_err"] <= 1e-5, errs
    for rec in ranks:
        assert rec["backend"] == "gloo" and all(rec["launches"].get(k, 0) > 0 for k in RASTER_KERNELS)
        assert rec["decode"]["pairs"] > 0


# The stage tools: the allocator's dump and the host clock against the device's.


def test_dump_keeps_the_lifetime_peak_through_memory_resets(dev, tmp_path):
    """`Benchmarker.memory` resets the allocator's peak for each stage; the
    dump's device record still holds the highest peak of the Benchmarker's
    life, at least every stage's peak, with JAX's keys."""
    import json

    from transplat_tpu_torch.utils.benchmarker import Benchmarker, device_memory_stats

    bench = Benchmarker(dev)
    with bench.memory("big"):
        big = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        del big
    with bench.memory("small"):
        small = torch.empty(1 << 20, dtype=torch.uint8, device=dev)
    bench.dump_memory(tmp_path / "peak_memory.json", extra={"note": 1})
    dump = json.loads((tmp_path / "peak_memory.json").read_text())
    assert set(dump) == {"device", "stages", "note"}
    stages = dump["stages"]
    assert stages["big"]["peak_bytes_in_use"] >= stages["big"]["bytes_in_use_before"] + (64 << 20)
    assert device_memory_stats(dev)["peak_bytes_in_use"] < stages["big"]["peak_bytes_in_use"]  # reset since
    assert dump["device"]["peak_bytes_in_use"] >= max(s["peak_bytes_in_use"] for s in stages.values())
    assert stages["small"]["peak_bytes_in_use_cumulative"] == stages["big"]["peak_bytes_in_use_cumulative"]
    assert {"bytes_in_use", "bytes_limit"} <= set(dump["device"])
    del small


def test_time_blocking_covers_the_device_time(dev):
    """The host clock up to the card's completion is at least the device
    time between CUDA events around the same block."""
    from transplat_tpu_torch.utils.benchmarker import Benchmarker

    bench = Benchmarker(dev)
    a = torch.randn(2048, 2048, device=dev)
    for _ in range(3):
        with bench.time_blocking("host") as out, bench.time("device"):
            out["result"] = a @ a @ a
    summary = bench.summarize()
    host, device = bench.execution_times["host"], bench.execution_times["device"]
    assert summary["host"]["count"] == 3 and all(h >= d > 0 for h, d in zip(host, device))


def test_stage_tools_launch_their_kernels_at_a_tiny_width(dev):
    """The train sub-graphs at the tiny width on the card: the render rows
    launch K1 and K3 (and K4 and K2 with the backward), the encoder rows K5
    and K7 (and K6 and K8 with the backward), LPIPS none; the stage profile
    counts the hand-written kernels' bytes in the matching stage and the
    decoder, and its Gaussians are the fused encoder's bit for bit."""
    from transplat_tpu_torch import bench_train_stages, profile_stages
    from transplat_tpu_torch.utils.stage_timing import time_rows

    encoder, lpips, batch = bench_train_stages.build(True, dev)
    rows = {r["stage"]: r["launches"] for r in time_rows(
        bench_train_stages.subgraphs(encoder, lpips, batch, dev).items(), dev, iters=1)}
    assert set(rows["render fwd"]) == {"bin_count", "bin_scan", "bin_place", "composite"}
    assert set(rows["render fwd+bwd"]) == {"bin_count", "bin_scan", "bin_place", "composite", "composite_bwd",
                                           "bin_bwd"}
    assert {"deform_scores_p1", "deform_scores_p4", "deform_vectors"} == set(rows["encoder fwd"])
    assert {"deform_scores_bwd_p1", "deform_scores_bwd_p4", "deform_vectors_bwd"} < set(rows["encoder fwd+bwd"])
    assert rows["lpips fwd"] == {} and rows["lpips fwd+bwd"] == {}

    encoder, batch = profile_stages.build(True, dev)
    result = profile_stages.profile(encoder, batch, 1, dev)
    by_stage = {r["stage"]: r for r in result["rows"]}
    assert by_stage["encoder_4b_cost_volume_matching"]["kernel_gb"] > 0 and by_stage["decoder"]["kernel_gb"] > 0
    assert all(r["kernel_gb"] == 0 for s, r in by_stage.items()
               if s not in ("encoder_4b_cost_volume_matching", "decoder"))
    with torch.no_grad():
        fused = encoder(*(torch.as_tensor(batch["context"][k], device=dev)
                          for k in ("image", "intrinsics", "extrinsics", "near", "far")))
    assert all(torch.equal(a, b) for a, b in zip(result["gaussians"], fused))


def test_sampler_backward_spans_on_autograds_thread_hold_their_launches(dev):
    """On the card autograd runs a backward on a thread of its own; the
    samplers' backward spans opened there reach the profiler's trace, and K6's
    and K8's launches lie inside them on the host's clock."""
    from torch.profiler import ProfilerActivity, profile

    scores, loc, aw = (t.requires_grad_() for t in _deform_case(64, 8, 4, 16, 16, 1, dev))
    value = torch.randn(2, 256, 32, device=dev, requires_grad=True)
    loc_v = torch.rand(2, 64, 4, 2, device=dev, requires_grad=True)
    aw_v = torch.rand(2, 64, 4, device=dev, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = deform.deform_sample_scores(scores, (16, 16), loc, aw).sum()
        out = out + deform.deform_sample_vectors(value, (16, 16), loc_v, aw_v).sum()
        torch.autograd.grad(out, [scores, loc, aw, value, loc_v, aw_v])
        torch.cuda.synchronize()
    events = prof.events()
    spans = {e.name: e for e in events if e.name.startswith("deform.") and e.device_type != torch.autograd.DeviceType.CUDA}
    assert set(spans) == {"deform.scores", "deform.vectors", "deform.scores_bwd", "deform.vectors_bwd"}
    assert spans["deform.scores_bwd"].thread != spans["deform.scores"].thread
    launches = [e.time_range.start for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")]
    for name in ("deform.scores_bwd", "deform.vectors_bwd"):
        r = spans[name].time_range
        assert any(r.start <= t <= r.end for t in launches), name
