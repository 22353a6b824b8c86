"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one:
a CUDA kernel has no CPU mode. The file imports nothing of JAX, so it runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_cases import (
    ADAPTER_TOL,
    GRAD_TOL,
    JPEG_MAE_TOL,
    STAGED_TOL,
    adapter_case,
    adapter_errors,
    assert_composite,
    project_case,
    project_errors,
    scaled_err,
)
from _torch_cases import synthetic_scene as scene
from transplat_tpu_torch import kernels
from transplat_tpu_torch.ops import deform
from transplat_tpu_torch.ops.rasterizer import api, binning, composite, projection
from transplat_tpu_torch.ops.rasterizer.api import RasterizeConfig

pytestmark = pytest.mark.cuda

# Kernel and plain version do the same float32 arithmetic, the plain version
# in another summation order (cumprod per chunk, sums over corners): 1e-5.
ATOL = 1e-5
# The hand-written kernels a request launches (FORWARD_KERNELS; also the
# adapter's and the projection's, once each) and a training step's backward
# adds (BACKWARD_KERNELS, by their counters in kernels.launches).
FORWARD_KERNELS = (
    "deform_scores_p1", "deform_scores_p4", "deform_vectors", "bin_count", "bin_scan", "bin_place", "composite",
)
BACKWARD_KERNELS = ("deform_scores_bwd_p1", "deform_scores_bwd_p4", "deform_vectors_bwd", "composite_bwd", "bin_bwd")
RASTER_KERNELS = ("bin_count", "bin_scan", "bin_place", "composite", "composite_bwd", "bin_bwd")
# What trainer.deterministic_kernels puts in place of K8's and K2's atomic
# modes, and the hand-written order of each sorted mode (no library sort).
SORTED_MODES = {"deform_vectors_bwd": "deform_vectors_bwd_sorted", "bin_bwd": "bin_bwd_sorted"}
SORTED_ORDERS = {"deform_vectors_bwd_sorted": "deform_vectors_bwd_order", "bin_bwd_sorted": "bin_bwd_order"}
# Device kernels of a library sort (cub's radix sort and scans, PyTorch's
# sorts). The port's own kernels are named bin_bwd_* and deform_vectors_bwd_*.
LIBRARY_SORT = re.compile(r"cub::|radix|sort", re.IGNORECASE)
OWN_KERNELS = re.compile(r"bin_bwd_|deform_vectors_bwd")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    kernels.strict_float32()
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
    proj = projection.project_views(*cams[:2], cams[2], *gs, image_shape)
    gfeat, _ = binning.sort_by_depth(proj)
    _assert_k1_equals_plain(gfeat, image_shape)


def _assert_k1_equals_plain(gfeat, image_shape):
    """K1's three kernels each equal to their plain versions and the lists to
    the classic route's, bit for bit; K2's order read off the lists equal
    to torch.sort's."""
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
    b, g = gfeat.shape[:2]
    lists = binning.bin_gaussians(gfeat, image_shape)
    assert torch.equal(lists.idx, idx) and torch.equal(lists.rects, ref.rects)
    assert all(torch.equal(x, y) for x, y in zip(binning.bin_bwd_order(lists, b, g), binning.bin_bwd_order_by_sort(lists, b, g)))


def _binning_case(dev, case):
    """Depth-sorted rows for the K1 edge cases: a grid wider than one
    shared-memory histogram, a dead-heavy and an all-dead view, Gaussians
    covering every tile, a count that is not a multiple of the chunk, no
    pairs at all."""
    g = 2 * binning.BIN_CHUNK + 37
    shape, tile = ((512, 768), 8) if case == "wide_grid" else ((100, 76), 16)
    cams, gs = scene(g, 3, dev, 5)
    gfeat, _ = binning.sort_by_depth(projection.project_views(*cams[:2], cams[2], *gs, shape))
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
    gfeat, colors = binning.sort_by_depth(projection.project_views(*cams[:2], cams[2], *gs, image_shape))
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
        assert scaled_err(a, b) <= GRAD_TOL["deform"], (name, "plain", scaled_err(a, b))
        assert scaled_err(a, c) <= GRAD_TOL["deform"], (name, "autograd", scaled_err(a, c))


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
        assert scaled_err(a, b) <= GRAD_TOL["deform"], (name, "plain", scaled_err(a, b))
        assert scaled_err(a, c_) <= GRAD_TOL["deform"], (name, "autograd", scaled_err(a, c_))
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
    gfeat, colors = binning.sort_by_depth(projection.project_views(*cams[:2], cams[2], *gs, image_shape))
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
        err = scaled_err(d_pair[:, lo:hi], d_pair_p[:, lo:hi])
        assert err <= GRAD_TOL["composite"], (name, err)
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
            assert a.shape == r.shape and scaled_err(a, r) <= GRAD_TOL["bin"], (deterministic, scaled_err(a, r))
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
    assert_composite(image, image_p, f"{label}: image")
    assert_composite(t_final, t_final_p, f"{label}: T_final")
    g_out = torch.from_numpy(np.random.default_rng(1).standard_normal(tuple(image.shape)).astype(np.float32)).to(dev)
    d_pair = composite._composite_bwd_cuda(gfeat, colors, lists, bg, image, t_final, g_out)
    d_pair_p = composite.composite_tiles_bwd_plain(gfeat, colors, lists, bg, image_p, t_final_p, g_out)
    again = composite._composite_bwd_cuda(gfeat, colors, lists, bg, image, t_final, g_out)
    torch.cuda.synchronize()
    assert d_pair.shape == d_pair_p.shape == (lists.idx.shape[0], binning.pair_width(c))
    assert bool(torch.isfinite(d_pair).all()) and torch.equal(d_pair, again), label
    for lo, hi, name in ((0, 2, "mean"), (2, 5, "conic"), (6, 7, "opacity"), (8, 8 + c, "colour")):
        if float(d_pair_p[:, lo:hi].abs().max()) > 0:
            assert scaled_err(d_pair[:, lo:hi], d_pair_p[:, lo:hi]) <= GRAD_TOL["composite"], (label, name)
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
                    assert scaled_err(a, r) <= GRAD_TOL["bin"], (b, deterministic, scaled_err(a, r))
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
    assert scaled_err(d_gfeat, ref_g) <= GRAD_TOL["bin"] and scaled_err(d_colors, ref_c) <= GRAD_TOL["bin"]


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
        assert scaled_err(a, b) <= GRAD_TOL["deform"], (name, scaled_err(a, b))
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
    assert scaled_err(got[0][keep], plain[0][keep]) <= GRAD_TOL["deform"]


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
        assert scaled_err(a, b) <= GRAD_TOL["deform"], (name, scaled_err(a, b))
    far = slice(q // 8, q // 8 + 3)
    assert float(got[1][:, far].abs().max()) == 0.0 and float(got[2][:, far].abs().max()) == 0.0
    if deterministic:
        again = deform._vectors_bwd_cuda(value, (h, w), loc, aw, gbar, deterministic=True)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def _library_sorts(fn) -> list[str]:
    """The device kernels of a library sort among what one call of fn launches (torch.profiler)."""
    from transplat_tpu_torch.utils.device_time import device_time

    names = [name for name, _ in device_time(fn)["events"]]
    return sorted({n[:80] for n in names if LIBRARY_SORT.search(n) and not OWN_KERNELS.search(n)})


@pytest.mark.parametrize("case", ["wide_grid", "dead_views", "cover_all", "ragged", "no_pairs"])
def test_bin_bwd_sorted_mode_orders_without_a_library_sort(dev, case):
    """K2's sorted mode on K1's lists of the edge-case scenes: its order (two
    kernels, read off the packed rectangles) equals torch.sort's permutation
    and segments, as does the plain version's; its output equals the route
    that took torch.sort's order bit for bit; and torch.profiler sees no
    kernel of a library sort inside the wrapper, where torch.sort's route,
    the control, shows one."""
    gfeat, shape, tile = _binning_case(dev, case)
    lists = binning.bin_gaussians(gfeat, shape, tile)
    b, g, _ = gfeat.shape
    d_pair = torch.randn((lists.idx.shape[0], binning.pair_width(3)), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))
    by_sort = binning.bin_bwd_order_by_sort(lists, b, g)
    for order in (binning.bin_bwd_order(lists, b, g), binning.bin_bwd_order_plain(lists, b, g)):
        assert all(torch.equal(x, y) for x, y in zip(order, by_sort))
    sort_route = binning.bin_bwd_sorted_plain(d_pair, *by_sort)
    got = binning.bin_bwd(d_pair, lists, b, g, 3, deterministic=True)
    assert all(torch.equal(x, y) for x, y in zip(got, binning.split_rows(sort_route, b, g, 3)))
    assert torch.equal(binning.bin_bwd_sorted(d_pair, *by_sort), sort_route)
    if case != "no_pairs":  # no pairs, no launches for the profiler to see
        assert not _library_sorts(lambda: binning.bin_bwd(d_pair, lists, b, g, 3, deterministic=True))
        assert _library_sorts(lambda: binning.bin_bwd_order_by_sort(lists, b, g))


@pytest.mark.parametrize("n,q,p,h,w", [(2, 4096, 4, 64, 64), (3, 100, 4, 5, 7), (2, 8192, 4, 128, 160), (1, 64, 2, 1, 1)])
def test_deform_vectors_bwd_sorted_mode_orders_without_a_library_sort(dev, n, q, p, h, w):
    """K8's sorted mode: its counting sort of the corner keys equals
    torch.sort's permutation and segments, as does the plain version's, on
    maps of 64x64, 5x7, 128x160 (four histogram slices) and 1x1 (most
    corners outside); its d_value equals the route that took torch.sort's
    order bit for bit; torch.profiler sees no kernel of a library sort inside
    the wrapper, where torch.sort's route, the control, shows one."""
    value, loc, aw, gbar = _vectors_case(n, q, p, h, w, 16, q + h, dev)
    keys, corner_w, _, _ = deform._vectors_bwd_launch(value, (h, w), loc, aw, gbar, True)
    rows = n * h * w
    by_sort = deform.vectors_bwd_order_by_sort(keys, rows)
    for order in (deform.vectors_bwd_order(keys, n, h * w), deform.vectors_bwd_order_plain(keys, rows)):
        assert all(torch.equal(x, y) for x, y in zip(order, by_sort))
    sort_route = deform.vectors_bwd_sorted_plain(gbar, corner_w, *by_sort, 4 * p)
    got = deform._vectors_bwd_cuda(value, (h, w), loc, aw, gbar, deterministic=True)
    assert torch.equal(got[0].reshape(sort_route.shape), sort_route)
    assert torch.equal(deform.vectors_bwd_sorted(gbar, corner_w, *by_sort, 4 * p), sort_route)
    assert not _library_sorts(lambda: deform._vectors_bwd_cuda(value, (h, w), loc, aw, gbar, deterministic=True))
    assert _library_sorts(lambda: deform.vectors_bwd_order_by_sort(keys, rows))


@pytest.mark.parametrize("model", ["transplat", "pixelsplat"])
def test_a_request_launches_every_forward_kernel_and_the_stage_kernels_once(dev, model):
    """One request (2 context views at 64x64 -> 2 target views) launches
    the render's forward kernels, and for TranSplat's tiny encoder also every
    sampler's, the Gaussian adapter's kernel once (pixelSplat's published
    encoder: at its 3 Gaussians a pixel) and the projection's once; no
    backward kernel."""
    from transplat_tpu_torch.dataset import synthetic_batch
    from transplat_tpu_torch.inference import render_novel_views
    from transplat_tpu_torch.model import build_encoder
    from transplat_tpu_torch.model.encoder_epipolar import EncoderEpipolarCfg

    if model == "transplat":
        encoder, want = _tiny_encoder(dev), FORWARD_KERNELS
    else:
        encoder, want = build_encoder(EncoderEpipolarCfg(), device=dev), RASTER_KERNELS[:4]
    batch = synthetic_batch(0, image_shape=(64, 64), num_target=2)
    kernels.reset_launches()
    out = render_novel_views(encoder, batch["context"], batch["target"], (64, 64), device=dev)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    assert bool(torch.isfinite(out).all())
    assert all(launches.get(k, 0) > 0 for k in want), launches
    assert launches.get("gaussian_adapter") == 1 and launches.get("project") == 1, launches
    assert not set(launches) & {*BACKWARD_KERNELS, *SORTED_MODES.values(), *SORTED_ORDERS.values()}, launches


@pytest.fixture(scope="module")
def full_request():
    """One full-width re10k serving request (time_kernels.request_lists: 2
    context views of 256x256 -> 4 target views x 131,072 Gaussians), its
    launch counts read from that request alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from transplat_tpu_torch.time_kernels import request_lists

    kernels.strict_float32()
    return request_lists(torch.device("cuda"))


def test_a_full_width_request_launches_every_forward_kernel_and_the_stage_kernels_once(dev, full_request):
    launches = full_request["launches"]
    assert tuple(full_request["color"].shape) == (1, 4, 256, 256, 3) and bool(torch.isfinite(full_request["color"]).all())
    assert full_request["gaussians"].means.shape[1] == 2 * 256 * 256
    assert all(launches.get(k, 0) > 0 for k in FORWARD_KERNELS), launches
    assert launches.get("gaussian_adapter") == 1 and launches.get("project") == 1, launches
    assert not set(launches) & {*BACKWARD_KERNELS, *SORTED_MODES.values(), *SORTED_ORDERS.values()}, launches


def test_raster_kernels_match_plain_on_the_full_width_request(dev, full_request):
    """K1 to K4 on the request's own Gaussians and lists (4 views x 131,072):
    K1's kernels and lists equal to their plain versions and K2's order to
    torch.sort's; K3 and K4 within their bounds of the plain versions (a
    coloured background); K2 in both modes within GRAD_TOL of its plain
    version, its sorted mode the same bits twice; the classic route's lists
    give K3, K4 and K2's sorted mode the same bits."""
    gfeat, colors, lists = (full_request[k] for k in ("gfeat", "colors", "lists"))
    b, g, _ = gfeat.shape
    c = colors.shape[-1]
    with torch.no_grad():
        _assert_k1_equals_plain(gfeat, (256, 256))
        bg = torch.rand((b, c), device=dev, generator=torch.Generator(device=dev).manual_seed(7))
        image, t_final, d_pair = _check_k3_k4(dev, gfeat, colors, lists, bg, (256, 256), "request")
        ref = binning.bin_bwd_plain(d_pair, lists, b, g, c)
        for deterministic in (False, True):
            got = binning.bin_bwd(d_pair, lists, b, g, c, deterministic=deterministic)
            assert all(scaled_err(x, r) <= GRAD_TOL["bin"] for x, r in zip(got, ref)), deterministic
        first = binning.bin_bwd(d_pair, lists, b, g, c, deterministic=True)
        assert all(torch.equal(x, y) for x, y in zip(first, binning.bin_bwd(d_pair, lists, b, g, c, deterministic=True)))
        classic = binning.bin_gaussians_plain(gfeat, (256, 256))
        c_image, c_t = composite._composite_fwd_cuda(gfeat, colors, classic, bg, (256, 256))
        g_out = torch.from_numpy(np.random.default_rng(1).standard_normal(tuple(image.shape)).astype(np.float32)).to(dev)
        c_pair = composite._composite_bwd_cuda(gfeat, colors, classic, bg, c_image, c_t, g_out)
        assert torch.equal(c_image, image) and torch.equal(c_t, t_final) and torch.equal(c_pair, d_pair)
        again = binning.bin_bwd(c_pair, classic, b, g, c, deterministic=True)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_deform_scores_on_the_full_width_request_epipolar_locations(dev, full_request):
    """K5 at P = 1 on the inputs of the request's epipolar coarse correlation."""
    scores, loc, aw, hw = full_request["samplings"][1]
    out = deform.deform_sample_scores(scores, hw, loc, aw)
    ref = deform.deform_sample_scores_plain(scores, hw, loc, aw)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= ATOL


def test_deform_scores_bwd_on_the_full_width_request_cross_attention(dev, full_request):
    """K6 at P = 4 on the inputs of the request's first cross-attention:
    within GRAD_TOL of its plain version and of autograd through the
    forward's plain version, through its own autograd wrapper too; the
    atomic and the deterministic runs give the same bits."""
    scores, loc, aw, hw = full_request["samplings"][4]
    gbar = torch.randn(loc.shape[:3], device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    got = deform._scores_bwd_cuda(scores, hw, loc, aw, gbar)
    again = deform._scores_bwd_cuda(scores, hw, loc, aw, gbar, deterministic=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = deform.deform_sample_scores_bwd_plain(scores, hw, loc, aw, gbar)
    leaves = [t.clone().requires_grad_(True) for t in (scores, loc, aw)]
    auto = torch.autograd.grad(deform.deform_sample_scores_plain(leaves[0], hw, leaves[1], leaves[2]), leaves, gbar)
    through = torch.autograd.grad(deform.deform_sample_scores(leaves[0], hw, leaves[1], leaves[2]), leaves, gbar)
    torch.cuda.synchronize()
    for name, a, p, u, t in zip(("scores", "loc", "weights"), got, plain, auto, through):
        assert max(scaled_err(a, p), scaled_err(a, u), scaled_err(t, p)) <= GRAD_TOL["deform"], name


def _tiny_step(dev, seed=0, deterministic_kernels=False):
    from transplat_tpu_torch.train_demo import build, tiny_encoder_cfg

    return build(tiny_encoder_cfg(), (64, 64), dev, seed, num_target=2, deterministic_kernels=deterministic_kernels)


@pytest.mark.parametrize("deterministic", [False, True])
def test_a_training_step_launches_every_backward_kernel(dev, deterministic):
    """One training step at the tiny width (MSE + LPIPS, backward, clip +
    Adam) launches every forward and every backward kernel: K8 and K2 in
    their atomic modes, or with trainer.deterministic_kernels in their sorted
    modes and those modes' orders, never both; the adapter and projection
    kernels not at all (a gradient is recorded: their plain versions)."""
    state, step, batch, gen = _tiny_step(dev, deterministic_kernels=deterministic)
    kernels.reset_launches()
    state, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0.0
    modes = SORTED_MODES if deterministic else {}
    for name in FORWARD_KERNELS + BACKWARD_KERNELS:
        assert launches.get(modes.get(name, name), 0) > 0, (name, launches)
    for atomic, sorted_mode in SORTED_MODES.items():
        if deterministic:
            assert launches.get(atomic, 0) == 0 and launches.get(SORTED_ORDERS[sorted_mode], 0) > 0, launches
        else:
            assert launches.get(sorted_mode, 0) == 0 and launches.get(SORTED_ORDERS[sorted_mode], 0) == 0, launches
    assert "gaussian_adapter" not in launches and "project" not in launches


def test_tiny_training_step_card_matches_cpu(dev):
    """One training step's loss and gradients (dropout off) at the tiny
    width: the kernels on the card against the plain versions on the CPU,
    from the same state. The rendered image is a step function of the
    Gaussians (integer cutoff radius, 1/255 alpha floor): ~1.5% of its
    values differ between card and CPU end to end in the worst case, and
    every gradient inherits those flipped terms. Bounds (those of
    tests/test_torch_training.py against JAX): loss within 1e-4 relative;
    the whole gradient within 0.01 of its norm; every leaf within 0.05 of
    its own norm plus 1e-2 of the whole gradient's (a bias in front of a
    normalisation has a gradient of pure rounding noise, which no relative
    bound can hold)."""
    from transplat_tpu_torch.inference import re10k_decoder_cfg
    from transplat_tpu_torch.loss import LossCfg
    from transplat_tpu_torch.training.step import loss_and_grads

    st_gpu, _, batch_gpu, _ = _tiny_step(dev, seed=3)
    with torch.no_grad():  # keep depths off the 1/far clip, where 1/disparity amplifies rounding
        st_gpu.encoder.depth_predictor.to_disparity_2.weight[0] *= 0.01
    st_cpu, _, _, _ = _tiny_step("cpu", seed=3)
    st_cpu.encoder.load_state_dict(st_gpu.encoder.state_dict())
    st_cpu.lpips.load_state_dict(st_gpu.lpips.state_dict())
    batch_cpu = {side: {k: v.cpu() for k, v in views.items()} for side, views in batch_gpu.items()}
    kernels.reset_launches()
    args = (LossCfg(), re10k_decoder_cfg(), (64, 64))
    metrics_g, grads_g = loss_and_grads(st_gpu, batch_gpu, *args, deterministic=True)
    metrics_c, grads_c = loss_and_grads(st_cpu, batch_cpu, *args, deterministic=True)
    assert all(kernels.launches.get(k, 0) > 0 for k in FORWARD_KERNELS + BACKWARD_KERNELS), kernels.launches
    loss_g, loss_c = float(metrics_g["loss"]), float(metrics_c["loss"])
    assert abs(loss_g - loss_c) / abs(loss_c) <= 1e-4, (loss_g, loss_c)
    diffs = {k: float((grads_g[k].cpu() - g).norm()) for k, g in grads_c.items()}
    norms = {k: float(g.norm()) for k, g in grads_c.items()}
    assert all(np.isfinite(d) for d in diffs.values())
    whole = sum(n**2 for n in norms.values()) ** 0.5
    leaf_err = {k: diffs[k] / (norms[k] + 1e-2 * whole) for k in diffs}
    worst = max(leaf_err, key=leaf_err.get)
    assert leaf_err[worst] <= 0.05, (worst, leaf_err[worst])
    assert sum(d**2 for d in diffs.values()) ** 0.5 / whole <= 0.01


def test_two_full_width_steps_with_the_switch_repeat_their_bits(dev):
    """From one state, two full-width re10k training steps with
    trainer.deterministic_kernels give the same loss, gradients, parameters,
    BatchNorm statistics and Adam moments bit for bit, through the sorted
    modes of K2 and K8 (and their orders) and not their atomic ones."""
    import copy

    from transplat_tpu_torch.inference import re10k_decoder_cfg, re10k_encoder_cfg
    from transplat_tpu_torch.loss import LossCfg
    from transplat_tpu_torch.train_demo import build
    from transplat_tpu_torch.training.step import loss_and_grads

    image = (256, 256)
    state, step, batch, gen = build(re10k_encoder_cfg(), image, dev, 0, num_target=4, deterministic_kernels=True)
    state, _ = step(state, batch, gen.manual_seed(0))  # a state past step 0
    passes = []
    for _ in range(2):
        metrics, grads = loss_and_grads(copy.deepcopy(state), batch, LossCfg(), re10k_decoder_cfg(), image,
                                        gen.manual_seed(1), deterministic_kernels=True)
        passes.append((float(metrics["loss"]), grads))
    assert passes[0][0] == passes[1][0]
    differ = [k for k, g in passes[0][1].items() if not torch.equal(g, passes[1][1][k])]
    assert not differ, differ[:5]
    del passes
    runs = []
    for _ in range(2):
        s = copy.deepcopy(state)
        torch.cuda.synchronize()
        kernels.reset_launches()
        s, metrics = step(s, batch, gen.manual_seed(2))
        torch.cuda.synchronize()
        runs.append((s, {k: float(v) for k, v in metrics.items()}, dict(kernels.launches)))
    (s0, m0, launches), (s1, m1, _) = runs
    assert m0 == m1
    sd0, sd1 = s0.encoder.state_dict(), s1.encoder.state_dict()
    differ = [k for k in sd0 if not torch.equal(sd0[k], sd1[k])]
    differ += [k for k in s0.opt_state.mu if not (torch.equal(s0.opt_state.mu[k], s1.opt_state.mu[k])
                                                   and torch.equal(s0.opt_state.nu[k], s1.opt_state.nu[k]))]
    assert not differ, differ[:5]
    for atomic, sorted_mode in SORTED_MODES.items():
        assert launches.get(sorted_mode, 0) > 0 and launches.get(atomic, 0) == 0, launches
    for name in FORWARD_KERNELS + ("deform_scores_bwd_p1", "deform_scores_bwd_p4", "composite_bwd",
                                   *SORTED_ORDERS.values()):
        assert launches.get(name, 0) > 0, (name, launches)


# The encoder's compute dtype and gradient checkpointing: each setting's
# fields over the tiny configuration with s2d_unet off.
PRECISION_SETTINGS = {
    "float32": {},
    "bfloat16": {"compute_dtype": "bfloat16"},
    "remat": {"remat_unet": True, "remat_matching": True},
    "bfloat16_remat": {"compute_dtype": "bfloat16", "remat_unet": True, "remat_matching": True},
}
# The bf16 step against the float32 step from one state (past Adam's first,
# sign-like update), dropout masks alike: the loss within PRECISION_LOSS_RTOL
# relative, the update's cosine at least PRECISION_MIN_COSINE. The tiny
# configuration on the CPU reads 3e-4 and 0.99 against JAX's bf16 step
# (tests/test_torch_training.py).
PRECISION_LOSS_RTOL = 1e-2
PRECISION_MIN_COSINE = 0.9


@pytest.mark.parametrize("width", ["tiny", "re10k"])
def test_precision_and_checkpointing(dev, width):
    """The training step in four settings (PRECISION_SETTINGS), at the tiny
    width (64x64) and at re10k's (256x256, the published encoder), each
    from one state one step past initialisation: K5 at P = 4 and K7 twice a
    step, four times under remat_matching (the backward runs each fine layer
    again); every forward and backward kernel launched; float32 at every
    kernel wrapper (a bf16 tensor there would raise); the bf16 step's loss
    and update near the float32 step's. With trainer.deterministic_kernels
    the checkpointed forward and backward equal the plain one bit for bit
    (loss, every gradient, the dropout generator's state), in float32 and in
    bf16. A bf16 request and a float32 one of the same weights are finite."""
    import dataclasses

    from transplat_tpu_torch.inference import re10k_decoder_cfg, re10k_encoder_cfg, render_novel_views
    from transplat_tpu_torch.loss import LossCfg
    from transplat_tpu_torch.model.encoder import EncoderTranSplat
    from transplat_tpu_torch.train_demo import RE10K_LR, RE10K_MAX_STEPS, build, tiny_encoder_cfg
    from transplat_tpu_torch.training import make_lr_schedule, make_optimizer, make_train_step
    from transplat_tpu_torch.training.step import TrainState, loss_and_grads

    image, cfg0 = ((64, 64), tiny_encoder_cfg()) if width == "tiny" else ((256, 256), re10k_encoder_cfg())
    base = dataclasses.replace(cfg0, s2d_unet=False)
    state0, step0, batch, gen = build(base, image, dev, 0, num_target=4)
    state0, _ = step0(state0, batch, gen.manual_seed(0))  # past Adam's first update
    before = {k: p.detach().clone() for k, p in state0.trainable().items()}
    optimizer = make_optimizer(make_lr_schedule(RE10K_LR, RE10K_MAX_STEPS), grad_clip=0.5)

    def state_as(cfg):
        """state0 with an encoder built from `cfg`: the same parameters, statistics, moments and step."""
        import copy

        encoder = EncoderTranSplat(cfg, device=dev)
        encoder.load_state_dict(state0.encoder.state_dict())
        return TrainState(step=state0.step, encoder=encoder, lpips=state0.lpips, opt_state=copy.deepcopy(state0.opt_state))

    checked = kernels.check_cuda_tensor
    seen_dtypes = set()

    def spy(name, t, dtype, ndim=None):
        seen_dtypes.add(str(t.dtype).replace("torch.", ""))
        return checked(name, t, dtype, ndim)

    warm = {}
    for name, fields in PRECISION_SETTINGS.items():
        cfg = dataclasses.replace(base, **fields)
        state = state_as(cfg)
        step = make_train_step(cfg, LossCfg(), re10k_decoder_cfg(), optimizer, image)
        state, metrics = step(state, batch, gen.manual_seed(1))  # from state0 alike
        warm[name] = (float(metrics["loss"]), torch.cat([(p.detach() - before[k]).reshape(-1)
                                                         for k, p in state.trainable().items()]))
        seen_dtypes.clear()
        kernels.check_cuda_tensor = spy
        try:
            kernels.reset_launches()
            state, metrics = step(state, batch, gen)
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
        finally:
            kernels.check_cuda_tensor = checked
        assert np.isfinite(float(metrics["loss"])), name
        assert seen_dtypes and "bfloat16" not in seen_dtypes, (name, seen_dtypes)
        fine = 4 if fields.get("remat_matching") else 2
        for counter in ("deform_scores_p4", "deform_vectors"):
            assert launches.get(counter, 0) == fine, (name, counter, launches)
        for counter in FORWARD_KERNELS + BACKWARD_KERNELS:
            assert launches.get(counter, 0) > 0, (name, counter)
    for name in ("bfloat16", "bfloat16_remat"):
        loss_rel = abs(warm[name][0] / warm["float32"][0] - 1.0)
        cosine = float(torch.nn.functional.cosine_similarity(warm[name][1], warm["float32"][1], dim=0))
        assert loss_rel <= PRECISION_LOSS_RTOL and cosine >= PRECISION_MIN_COSINE, (name, loss_rel, cosine)

    for dtype in ("float32", "bfloat16"):
        runs = []
        for fields in ({}, {"remat_unet": True, "remat_matching": True}):
            cfg = dataclasses.replace(base, compute_dtype=dtype, **fields)
            g = torch.Generator(device=dev).manual_seed(2)
            metrics, grads = loss_and_grads(state_as(cfg), batch, LossCfg(), re10k_decoder_cfg(), image, g,
                                            deterministic_kernels=True)
            runs.append((float(metrics["loss"]), grads, g.get_state()))
        (l0, g0, r0), (l1, g1, r1) = runs
        differ = [k for k in g0 if not torch.equal(g0[k], g1[k])]
        assert l0 == l1 and not differ and torch.equal(r0, r1), (dtype, differ[:5])

    for dtype in ("float32", "bfloat16"):
        encoder = state_as(dataclasses.replace(base, compute_dtype=dtype)).encoder
        out = render_novel_views(encoder, batch["context"], batch["target"], image, device=dev)
        assert bool(torch.isfinite(out).all()), dtype


def test_fit_resume_with_the_switch_is_exact(dev):
    """Path 3 with trainer.deterministic_kernels at full width on the golden
    scene: Trainer.fit for 4 steps with a checkpoint in the middle, then a
    fresh Trainer resumed from it. The resumed steps' metrics and the final
    parameters, BatchNorm statistics and Adam moments equal the first run's
    exactly; the sorted modes of K2 and K8 ran, their atomic modes not."""
    import itertools
    import json
    import shutil
    import tempfile

    from transplat_tpu_torch.config import load_config
    from transplat_tpu_torch.dataset import golden_scene_batch
    from transplat_tpu_torch.loss import LPIPS
    from transplat_tpu_torch.training import Trainer

    steps, half = 4, 2
    batch = golden_scene_batch(num_context=2, num_target=4, image_shape=(256, 256))
    lpips = LPIPS(device=dev, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        def config(run: str):
            return load_config(
                "re10k",
                optimizer=dict(lr=4e-4, cosine_lr=True, warm_up_steps=1),
                trainer=dict(max_steps=steps, num_sanity_val_steps=0, val_check_interval=steps, seed=0,
                             deterministic_kernels=True),
                checkpointing=dict(save_dir=f"{tmp}/{run}/checkpoints", every_n_train_steps=half),
            )

        kernels.reset_launches()
        first = Trainer(config("run"), log_fn=lambda m: None, device=dev, lpips=lpips, log_every=1)
        state = first.fit(itertools.repeat(batch), max_steps=steps)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        for atomic, sorted_mode in SORTED_MODES.items():
            assert launches.get(sorted_mode, 0) > 0 and launches.get(SORTED_ORDERS[sorted_mode], 0) > 0
            assert launches.get(atomic, 0) == 0, launches
        want = {k: v.clone() for k, v in state.encoder.state_dict().items()}
        moments = {k: (state.opt_state.mu[k].clone(), state.opt_state.nu[k].clone()) for k in state.opt_state.mu}
        del state
        resumed_cfg = config("resumed")
        Path(resumed_cfg.checkpointing.save_dir).mkdir(parents=True)
        shutil.copy(f"{tmp}/run/checkpoints/step_{half:08d}.pt", resumed_cfg.checkpointing.save_dir)
        logs: list[str] = []
        resumed = Trainer(resumed_cfg, log_fn=logs.append, device=dev, lpips=lpips, log_every=1)
        state = resumed.fit(itertools.repeat(batch), max_steps=steps)
        assert f"resumed from step {half}" in logs and state.step == steps, logs[:3]
        records = {}
        for run in ("run", "resumed"):
            lines = [json.loads(line) for line in Path(f"{tmp}/{run}/metrics.jsonl").read_text().splitlines()]
            records[run] = {r["step"]: {k: v for k, v in r.items() if k != "s_per_it"} for r in lines if "loss" in r}
        assert sorted(records["resumed"]) == list(range(half + 1, steps + 1))
        for i in range(half + 1, steps + 1):
            assert records["resumed"][i] == records["run"][i], (i, records["resumed"][i], records["run"][i])
        have = state.encoder.state_dict()
        differ = [k for k in want if not torch.equal(want[k], have[k])]
        differ += [k for k, (mu, nu) in moments.items()
                   if not (torch.equal(mu, state.opt_state.mu[k]) and torch.equal(nu, state.opt_state.nu[k]))]
        assert not differ, differ[:5]


def test_jpeg_route_on_the_card_decodes_its_source(dev):
    """The card machine's JPEG route (nvJPEG where the host has no libjpeg):
    frames it encodes at quality 95 decode within JPEG_MAE_TOL of their
    source pixels, a truncated or foreign stream raises."""
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


# A narrow encoder at 64x64 for the command line's modes.
TINY_YAML = (
    "dataset: {image_shape: [64, 64]}\n"
    "encoder: {d_feature: 16, num_depth_candidates: 16, costvolume_unet_feat_dim: 16,"
    " costvolume_unet_channel_mult: [1, 1], costvolume_unet_attn_res: [2], depth_unet_feat_dim: 8,"
    " depth_unet_attn_res: [4], depth_unet_channel_mult: [1, 1, 1], dav2_encoder: vits, dav2_input_size: 28,"
    " gaussian_adapter: {sh_degree: 1}}\n"
)


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
    (tmp_path / "tiny.yaml").write_text(TINY_YAML + "trainer: {batch_size: 1, num_workers: 2, val_check_interval: 0.5}\n")
    monkeypatch.chdir(tmp_path)
    run = tmp_path / "run"
    assert main(["train", "--config", "tiny.yaml", "--dataset-root", str(data), "--max-steps", "2",
                 "--output", str(run)]) == 0
    assert (run / "checkpoints" / "step_00000002.pt").exists()
    vals = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines() if "val_psnr" in x]
    assert [r["step"] for r in vals] == [1, 2] and all(r["val_scenes"] == ["te_0"] for r in vals)


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, (*prefix, k)) if isinstance(v, dict) else {(*prefix, k): np.asarray(v)})
    return out


def test_main_test_with_every_artifact_then_evaluate_batch_and_compute_metrics(dev, tmp_path, monkeypatch):
    """`main test` on the card at 64x64 from weight files (a seeded narrow
    encoder's tree in the JAX layout, seeded LPIPS weights) over seeded test
    chunks, through the index `main generate-index` writes, with every
    artifact: the request's kernels launched (counts reset just before),
    renders, videos, PLY, stage timing, analysis and finite LPIPS written.
    The encoder it loads equals the tree bit for bit, and
    Evaluator.evaluate_batch on the card renders each scene as the CPU does
    from the same weights (the tiny slice's bound: 98% of the values within
    1e-4, all within 0.05). Then a second `main test` from seed-init weights
    and `compute-metrics` over both runs' renders on the card."""
    import json

    from _torch_cases import seeded_lpips_state
    from transplat_tpu_torch.config import load_config
    from transplat_tpu_torch.convert import to_jax_tree
    from transplat_tpu_torch.dataset import chunks
    from transplat_tpu_torch.dataset.loader import DataLoader
    from transplat_tpu_torch.evaluation import Evaluator
    from transplat_tpu_torch.inference import init_random
    from transplat_tpu_torch.main import main
    from transplat_tpu_torch.model.encoder import EncoderTranSplat
    from transplat_tpu_torch.training.schedule import make_lr_schedule
    from transplat_tpu_torch.training.step import create_train_state, make_optimizer

    data = tmp_path / "data"
    chunks.write_chunk(data / "test" / "000000.torch", [chunks.make_scene(f"te_{i}", 60, seed=5 + i) for i in range(2)])
    monkeypatch.chdir(tmp_path)
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    index = tmp_path / "index.json"
    cfg = load_config("re10k", yaml_path=tmp_path / "tiny.yaml", dataset=dict(roots=[str(data)]),
                      test=dict(evaluation_index=str(index)),
                      checkpointing=dict(pretrained_model=str(tmp_path / "tree.npy")))
    seeded = EncoderTranSplat(cfg.encoder, device="cpu")
    init_random(seeded, 17)
    with torch.no_grad():  # keep depths off the 1/far clip (see test_torch_encoder.py)
        seeded.depth_predictor.to_disparity_2.weight[0] *= 0.01
    tree = to_jax_tree(seeded)
    np.save(tmp_path / "tree.npy", tree, allow_pickle=True)
    np.save(tmp_path / "lpips.npy", seeded_lpips_state("torchvision", seed=2), allow_pickle=True)
    assert main(["generate-index", "--dataset-root", str(data), "--output", str(index)]) == 0
    common = ["--config", "tiny.yaml", "--dataset-root", str(data), "--evaluation-index", str(index),
              f"checkpointing.lpips_weights={tmp_path / 'lpips.npy'}"]
    out = tmp_path / "weights"
    torch.cuda.synchronize()
    kernels.reset_launches()
    assert main(["test", *common, "--output", str(out), "--save-image", f"checkpointing.pretrained_model={tmp_path / 'tree.npy'}",
                 "test.stage_timing=true", "test.analyze=true", "test.save_video=true", "test.save_ply=true"]) == 0
    torch.cuda.synchronize()
    assert all(kernels.launches.get(k, 0) > 0 for k in FORWARD_KERNELS), kernels.launches
    files = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
    for scene in ("te_0", "te_1"):
        for name in ("color/0000.png", "wobble.mp4", "interpolation.mp4", "gaussians.ply"):
            assert f"{scene}/{name}" in files
    for name in ("analysis_avg.json", "analysis_per_scene.json", "benchmark.json", "scores_all_avg.json",
                 "scores_per_scene.json"):
        assert name in files
    assert all(np.isfinite(s["lpips"]) for s in json.loads((out / "scores_per_scene.json").read_text()).values())

    state = create_train_state(cfg.encoder, make_optimizer(make_lr_schedule(cfg.optimizer.lr, 1000)), None,
                               device=dev, seed=0, ckpt_cfg=cfg.checkpointing)
    loaded, want = _leaves(to_jax_tree(state.encoder)), _leaves(tree)
    assert sorted(loaded) == sorted(want) and all(np.array_equal(loaded[k], want[k]) for k in want)
    on_card = Evaluator(cfg, state.encoder.eval(), None, device=dev)
    on_cpu = Evaluator(cfg, seeded.eval(), None, device="cpu")
    scenes = []
    for batch in DataLoader(on_card.make_dataset(), batch_size=1, drop_last=False):
        kernels.reset_launches()
        scores, color = on_card.evaluate_batch(batch)
        torch.cuda.synchronize()
        assert all(kernels.launches.get(k, 0) > 0 for k in FORWARD_KERNELS), kernels.launches
        assert scores["render_overflow"] == 0 and np.isfinite(scores["psnr"]) and np.isfinite(scores["ssim"])
        diff = np.abs(color - on_cpu.evaluate_batch(batch)[1])
        assert np.mean(diff > 1e-4) < 0.02 and diff.max() < 0.05, (np.mean(diff > 1e-4), diff.max())
        scenes.append(batch["scene"][0])
    assert sorted(scenes) == ["te_0", "te_1"]

    other = tmp_path / "seeded"
    assert main(["test", *common, "--output", str(other), "--save-image"]) == 0
    assert main(["compute-metrics", "--ground-truth", str(out), "--method", f"weights={out}",
                 "--method", f"seeded={other}", "--output", str(tmp_path / "m")]) == 0
    summary = json.loads((tmp_path / "m" / "summary.json").read_text())
    assert summary["weights"]["psnr"] == pytest.approx(120.0) and summary["weights"]["ssim"] == pytest.approx(1.0)
    assert np.isfinite(summary["seeded"]["psnr"]) and summary["seeded"]["psnr"] < 120.0


def test_main_bench_runs_the_card_kernels_at_a_tiny_size(dev, monkeypatch, capsys):
    """`main bench` on the card, its sizes cut as tests/test_torch_cli.py cuts
    them on the CPU (bench.run's keyword arguments; the training step at the
    narrow encoder's 64x64): one JSON line of finite positive numbers, the
    card's name as its device, every forward and backward kernel launched."""
    import functools
    import json

    from transplat_tpu_torch import bench
    from transplat_tpu_torch.main import main
    from transplat_tpu_torch.train_demo import tiny_encoder_cfg

    train = dict(encoder_cfg=tiny_encoder_cfg(), image_shape=(64, 64), inner=1, iters=1)
    monkeypatch.setattr(bench, "run", functools.partial(bench.run, views=2, gaussians=4096, image=64, inner=2, outer=1,
                                                        train=True, train_kwargs=train))
    kernels.reset_launches()
    assert main(["bench"]) == 0
    torch.cuda.synchronize()
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    numbers = {k: v for k, v in record.items() if isinstance(v, (int, float)) and not isinstance(v, bool)}
    assert all(np.isfinite(v) and v > 0 for v in numbers.values()), record
    assert record["device"] == torch.cuda.get_device_name(0) and record["train_step_ms"] > 0, record
    assert all(kernels.launches.get(k, 0) > 0 for k in FORWARD_KERNELS + BACKWARD_KERNELS), kernels.launches


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
    gfeat, colors = binning.sort_by_depth(projection.project_views(*cams[:2], cams[2], *gs, image_shape))
    lists = binning.bin_gaussians(gfeat, image_shape)
    classic = binning.bin_gaussians_plain(gfeat, image_shape)
    assert torch.equal(lists.idx, classic.idx) and torch.equal(lists.ranges, classic.ranges)
    assert lists.idx.numel() > 0 and lists.ranges.dtype == torch.int32
    plain, _, _ = composite.composite_tiles_plain(gfeat, colors, lists, bg, image_shape)
    torch.cuda.synchronize()
    assert_composite(out.color, plain, "30-view decode")


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
    """The parallel step at the tiny width: two gloo ranks
    sharing the card take one step (dp: the joined batch split over the
    ranks, dropout off; sp: the views split, dropout on), held against the
    one-process step on the card; every rank launched K1-K4 in its step, and
    an sp rank's sharded decode equals the unsharded one within 1e-5. The
    step's bounds: sp as tests/test_torch_parallel.py's STEP_TOL; dp a few
    times its readings at this width on an H100 (norm 2.3e-5, gradient
    1.5e-4, worst leaf 1.1e-2, update cosine 1 - 1.4e-4), which round
    further from the joined batch than the CPU's; the loss and BatchNorm
    statistics 1e-5."""
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
    launch K1 and K3 (and K4 and K2 with the backward; the projection
    kernel without it), the encoder rows K5
    and K7 (and K6 and K8 with the backward), the forward alone also the
    Gaussian adapter's kernel, LPIPS none; the stage profile counts the
    hand-written kernels' bytes in the matching stage, the adapter stage
    and the decoder, and its Gaussians are the fused encoder's bit for bit."""
    from transplat_tpu_torch import bench_train_stages, profile_stages
    from transplat_tpu_torch.utils.stage_timing import time_rows

    encoder, lpips, batch = bench_train_stages.build(True, dev)
    rows = {r["stage"]: r["launches"] for r in time_rows(
        bench_train_stages.subgraphs(encoder, lpips, batch, dev).items(), dev, iters=1)}
    # Without a gradient the render's projection takes its kernel (csrc/project.cu).
    assert set(rows["render fwd"]) == {"project", "bin_count", "bin_scan", "bin_place", "composite"}
    assert set(rows["render fwd+bwd"]) == {"bin_count", "bin_scan", "bin_place", "composite", "composite_bwd",
                                           "bin_bwd"}
    assert {"deform_scores_p1", "deform_scores_p4", "deform_vectors", "gaussian_adapter"} == set(rows["encoder fwd"])
    assert "gaussian_adapter" not in rows["encoder fwd+bwd"]  # under a gradient stage 5 takes its plain version
    assert {"deform_scores_bwd_p1", "deform_scores_bwd_p4", "deform_vectors_bwd"} < set(rows["encoder fwd+bwd"])
    assert rows["lpips fwd"] == {} and rows["lpips fwd+bwd"] == {}

    encoder, batch = profile_stages.build(True, dev)
    result = profile_stages.profile(encoder, batch, 1, dev)
    by_stage = {r["stage"]: r for r in result["rows"]}
    with_kernels = ("encoder_4b_cost_volume_matching", "encoder_5_gaussian_adapter", "decoder")
    assert all(by_stage[s]["kernel_gb"] > 0 for s in with_kernels)
    assert all(r["kernel_gb"] == 0 for s, r in by_stage.items() if s not in with_kernels)
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


# The Gaussian adapter stage's kernel (csrc/gaussian_adapter.cu) against the
# plain stage, on the card.


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(256, 256), (37, 53)])
@pytest.mark.parametrize("b,v,step", [(1, 2, 3), (2, 3, 50)])
def test_gaussian_adapter_matches_plain(dev, b, v, step, shape, degree):
    """All six outputs within ADAPTER_TOL of the plain stage: SH degrees 0-4,
    cameras turned by the identity, near 180 degrees and at random, off-centre
    intrinsics, inside (step 3) and after (step 50) the opacity warm-up; one
    launch, no host synchronisation."""
    from transplat_tpu_torch.model.encoder import adapt_stage, adapt_stage_plain

    cfg, args = adapter_case(dev, b, v, shape, degree, step, seed=degree + 10 * b)
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = adapt_stage(cfg, *args, with_aux=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.launches == {"gaussian_adapter": 1}
    errs = adapter_errors(got, adapt_stage_plain(cfg, *args, with_aux=True))
    assert set(errs) == {"means", "covariances", "harmonics", "opacities", "scales", "rotations"}
    assert max(errs.values()) <= ADAPTER_TOL, errs


@pytest.mark.parametrize("step", [0, 5, 10])
def test_gaussian_adapter_opacity_exponents_and_row_layout(dev, step):
    """The warm-up's exponents that PyTorch's pow special-cases (0.5, 1, 2),
    on raw channels laid out as rows rather than planes."""
    from transplat_tpu_torch.model.encoder import adapt_stage, adapt_stage_plain

    cfg, args = adapter_case(dev, 2, 2, (37, 53), 4, step, seed=step, planar=False)
    assert args[2].stride()[-1] == 1
    errs = adapter_errors(adapt_stage(cfg, *args, with_aux=True), adapt_stage_plain(cfg, *args, with_aux=True))
    assert max(errs.values()) <= ADAPTER_TOL, errs


def test_gaussian_adapter_repeats_its_bits_and_the_plain_path_syncs(dev):
    from transplat_tpu_torch.model.encoder import adapt_stage, adapt_stage_plain

    cfg, args = adapter_case(dev, 1, 2, (256, 256), 4, 3, seed=7)
    first, second = adapt_stage(cfg, *args, with_aux=True), adapt_stage(cfg, *args, with_aux=True)
    assert all(torch.equal(first[k], second[k]) for k in first)
    # The witness that the sync check above sees a host read: the plain stage's inverses.
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            adapt_stage_plain(cfg, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_gaussian_adapter_rejects_bad_input_and_grad_takes_the_plain_path(dev):
    from transplat_tpu_torch.model.adapter import adapt_gaussians_fused
    from transplat_tpu_torch.model.encoder import adapt_stage
    from transplat_tpu_torch.utils import trace

    cfg, args = adapter_case(dev, 1, 2, (16, 24), 2, 3, seed=1)
    extr, intr, raw, depth, density, step, shape = args
    call = lambda *t, **kw: adapt_gaussians_fused(cfg.gaussian_adapter, *t, 1.0, 1, shape, **kw)  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        call(extr.cpu(), intr.cpu(), raw.cpu(), depth.cpu(), density.cpu())
    with pytest.raises(ValueError, match="float64"):
        call(extr, intr, raw.double(), depth, density)
    with pytest.raises(ValueError, match="shape"):
        call(extr, intr, raw[..., :-1], depth, density)
    with pytest.raises(ValueError, match="contiguous"):
        call(extr, intr, raw, depth.repeat(1, 1, 1, 2)[..., ::2], density)
    with pytest.raises(ValueError, match="requires grad"):
        call(extr, intr, raw.clone().requires_grad_(), depth, density)
    raw_g = raw.clone().requires_grad_()
    trace.reset_counters()
    kernels.reset_launches()
    out = adapt_stage(cfg, extr, intr, raw_g, depth, density, step, shape)
    assert trace.counters() == {"adapter.plain": 1} and kernels.launches == {}
    assert out["harmonics"].requires_grad
    with torch.no_grad():
        adapt_stage(cfg, extr, intr, raw_g, depth, density, step, shape)
    assert trace.counters() == {"adapter.plain": 1, "adapter.fused": 1} and kernels.launches == {"gaussian_adapter": 1}


def test_encoder_takes_the_adapter_kernel_only_without_a_gradient(dev):
    """The tiny encoder on the card: a forward without a gradient takes the
    kernel, one with (eval mode, parameters requiring grad) the plain
    stage; the two give the same Gaussians within ADAPTER_TOL."""
    from transplat_tpu_torch.dataset import synthetic_batch
    from transplat_tpu_torch.utils import trace

    encoder = _tiny_encoder(dev)
    batch = synthetic_batch(0, image_shape=(64, 64), num_target=1)
    ctx = [torch.as_tensor(batch["context"][k], device=dev) for k in ("image", "intrinsics", "extrinsics", "near", "far")]
    trace.reset_counters()
    kernels.reset_launches()
    with torch.no_grad():
        fast = encoder(*ctx)
    assert trace.counters() == {"adapter.fused": 1} and kernels.launches["gaussian_adapter"] == 1
    plain = encoder(*ctx)
    assert trace.counters() == {"adapter.fused": 1, "adapter.plain": 1} and kernels.launches["gaussian_adapter"] == 1
    assert plain.means.requires_grad
    for name, a, b in zip(fast._fields, fast, plain):
        err = float((a - b.detach()).abs().max() / b.detach().abs().max())
        assert err <= ADAPTER_TOL, (name, err)


PROJECT_SHAPE = (96, 128)


@pytest.mark.parametrize("sets,views", [(1, 1), (1, 3), (3, 1)])
@pytest.mark.parametrize("scale_invariant", [True, False])
@pytest.mark.parametrize("degree", range(5))
def test_projection_kernel_equals_plain_on_exact_cameras(dev, degree, scale_invariant, sets, views):
    """csrc/project.cu against the plain chain on cameras that every
    inverse rounds alike: keys, rows and radii bit for bit, colours within
    PROJECT_COLOR_TOL, the same depth order (_torch_cases.project_errors)."""
    from transplat_tpu_torch.ops.rasterizer.projection import project_rows_kernel, project_rows_plain

    args = project_case(dev, sets, views, 4096, degree, 10 * degree + sets + views, exact=True)
    kernels.reset_launches()
    got = project_rows_kernel(*args, PROJECT_SHAPE, scale_invariant)
    assert kernels.launches == {"project": 1}
    errs = project_errors(got, project_rows_plain(*args, PROJECT_SHAPE, scale_invariant))
    assert errs["equal"] and errs["live"] > 0 and errs["live"] < errs["gaussians"]


@pytest.mark.parametrize("sets,views", [(1, 1), (1, 3), (3, 1)])
@pytest.mark.parametrize("scale_invariant", [True, False])
@pytest.mark.parametrize("degree", range(5))
def test_projection_kernel_matches_plain_on_turned_cameras(dev, degree, scale_invariant, sets, views):
    """On turned, off-centre cameras the two inverses round apart: every
    field within PROJECT_TOL of the float64 chain (a conic's scaled by its
    condition number) or PROJECT_GROWTH times the float32 chain's own gap,
    colours within PROJECT_COLOR_TOL, radius and cull
    flips counted and bounded, the depth order equal but at ties."""
    from transplat_tpu_torch.ops.rasterizer.projection import project_rows_kernel, project_rows_plain

    args = project_case(dev, sets, views, 4096, degree, 100 + 10 * degree + sets + views)
    got = project_rows_kernel(*args, PROJECT_SHAPE, scale_invariant)
    plain = project_rows_plain(*args, PROJECT_SHAPE, scale_invariant)
    exact64 = project_rows_plain(*(a.double() for a in args), PROJECT_SHAPE, scale_invariant)
    errs = project_errors(got, plain, exact64)
    assert 0 < errs["live"] < errs["gaussians"]


@pytest.mark.parametrize("views,g", [(1, 131_072), (3, 131_072), (3, 393_216)])
def test_projection_kernel_at_the_serving_shapes(dev, views, g):
    """re10k-view's (1 x 131,072), re10k-serve's (3 x 131,072) and
    pixelSplat's (3 x 393,216) shapes at SH 4 and 256^2: the kernel against
    the plain chain as above."""
    from transplat_tpu_torch.ops.rasterizer.projection import project_rows_kernel, project_rows_plain

    args = project_case(dev, 1, views, g, 4, views + g % 997)
    got = project_rows_kernel(*args, (256, 256))
    plain = project_rows_plain(*args, (256, 256))
    exact64 = project_rows_plain(*(a.double() for a in args), (256, 256))
    errs = project_errors(got, plain, exact64)
    assert errs["live"] > g // 2


def test_render_takes_the_projection_kernel_once_without_a_gradient(dev):
    """`render` without a gradient launches the projection kernel once and
    counts render.project.fused; under a gradient it launches none and
    counts render.project.plain; both routes give the same colours and radii
    on exact cameras. A decode's sets (b = 2 scenes x 3 views) render as the
    same Gaussians repeated for every view; render_depth takes the kernel
    too (its feature in place of the colours)."""
    from transplat_tpu_torch.model.decoder import decode_splatting
    from transplat_tpu_torch.model.types import Gaussians
    from transplat_tpu_torch.ops.rasterizer.projection import repeat_sets
    from transplat_tpu_torch.utils import trace

    extr, intr, near, *gs = project_case(dev, 2, 3, 3000, 4, 7, exact=True)
    far = torch.full_like(near, 100.0)
    bg = torch.zeros(6, 3, device=dev)
    trace.reset_counters()
    kernels.reset_launches()
    with torch.no_grad():
        fused = api.render(extr, intr, near, far, PROJECT_SHAPE, bg, *gs)
        repeated = api.render(extr, intr, near, far, PROJECT_SHAPE, bg, *(repeat_sets(x, 3) for x in gs))
    assert trace.counters()["render.project.fused"] == 2 and kernels.launches["project"] == 2
    assert torch.equal(fused.color, repeated.color) and torch.equal(fused.radii, repeated.radii)
    leaves = [x.clone().requires_grad_() for x in gs]
    kernels.reset_launches()
    plain = api.render(extr, intr, near, far, PROJECT_SHAPE, bg, *leaves)
    assert "project" not in kernels.launches and trace.counters()["render.project.plain"] == 1
    assert plain.color.grad_fn is not None
    assert_composite(fused.color, plain.color.detach(), "fused vs plain route")
    assert torch.equal(fused.radii, plain.radii)
    with torch.no_grad():
        decoded = decode_splatting(Gaussians(*gs), extr.reshape(2, 3, 4, 4), intr.reshape(2, 3, 3, 3),
                                   near.reshape(2, 3), far.reshape(2, 3), PROJECT_SHAPE, depth_mode="depth")
        depth_fused = api.render_depth(extr, intr, near, far, PROJECT_SHAPE, gs[0], gs[1], gs[3])
    assert torch.equal(decoded.color.reshape(fused.color.shape), fused.color)
    assert torch.equal(decoded.depth.reshape(depth_fused.shape), depth_fused)
    kernels.reset_launches()
    depth_plain = api.render_depth(extr, intr, near, far, PROJECT_SHAPE, *(x for i, x in enumerate(leaves) if i != 2))
    assert "project" not in kernels.launches
    assert_composite(depth_fused, depth_plain.detach(), "render_depth fused vs plain route")

