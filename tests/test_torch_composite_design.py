"""The host-side pieces of the compositing kernels' design (K3, K4), on the CPU.

csrc/composite.cuh culls, per warp, the list entries whose conservative pixel
rectangle misses the warp's 8x4 pixels, and both kernels take their tiles
longest list first. ops/rasterizer/composite.py holds the plain versions of
both (`entry_rects`, `warp_masks`, `tile_order`); here they are held against
a brute-force keep test, against a plain walk with and without the cull, and
the measuring report's counts (raster_report.py) against the plain
compositor's.
"""

import numpy as np
import pytest
import torch

from chip_smoke import synthetic_scene
from transplat_tpu_torch import raster_report
from transplat_tpu_torch.ops.rasterizer import api, binning, composite
from transplat_tpu_torch.ops.rasterizer.projection import gaussian_alpha

TILE = 16
WARPS = TILE * TILE // 32


def _gaussians(rng, n, kind):
    """(n, 8) geometry rows and (n, 2) tile origins. Conics are wide, so that
    alpha stays above 1/255 far out and the radius test decides the edge."""
    origin = rng.integers(0, 8, (n, 2)).astype(np.float32) * TILE
    if kind == "centres":  # means on exact pixel centres
        mean = origin + rng.integers(-20, 36, (n, 2))
    elif kind == "off_centres":
        mean = origin + rng.uniform(-20.0, 36.0, (n, 2))
    elif kind == "outside":  # means beyond the tile's edges
        side = rng.choice([-1.0, 1.0], (n, 2))
        mean = origin + 7.5 + side * rng.uniform(8.0, 30.0, (n, 2))
    else:  # half-pixel means
        mean = origin + rng.integers(-20, 36, (n, 2)) + 0.5
    radius = rng.integers(0, 24, n).astype(np.float32)  # whole numbers, as the projection gives them
    a = rng.uniform(1e-4, 5e-3, n)
    c = rng.uniform(1e-4, 5e-3, n)
    b = rng.uniform(-0.5, 0.5, n) * np.sqrt(a * c)
    rows = np.stack([mean[:, 0], mean[:, 1], a, b, c, radius, rng.uniform(0.05, 1.0, n), np.zeros(n)], 1)
    return torch.from_numpy(rows.astype(np.float32)), torch.from_numpy(origin)


def _tile_pixels(footprint=composite.FOOTPRINT):
    """(256, 2) tile-local pixel of each thread and (256,) its warp, as csrc/composite.cuh lays them out."""
    fw, fh = footprint
    lane = torch.arange(TILE * TILE)
    warp, lw = lane // 32, lane % 32
    x = (warp % (TILE // fw)) * fw + lw % fw
    y = (warp // (TILE // fw)) * fh + lw // fw
    return torch.stack([x, y], -1), warp


@pytest.mark.parametrize("kind", ["centres", "off_centres", "half_pixel", "outside"])
def test_entry_rects_hold_every_kept_pixel(kind):
    """No pixel that passes the keep test (or the radius test alone) lies
    outside the entry's rectangle or in a warp its mask leaves out."""
    rows, origin = _gaussians(np.random.default_rng(len(kind)), 4000, kind)
    rects = composite.entry_rects(rows, origin[:, 0], origin[:, 1])
    pix, warp = _tile_pixels()
    xy = origin[:, None, :] + pix[None].float()  # (n, 256, 2)
    alpha = gaussian_alpha(rows[:, None, 2:5], rows[:, None, :2], rows[:, None, 6], xy, rows[:, None, 5])
    dx, dy = xy[..., 0] - rows[:, None, 0], xy[..., 1] - rows[:, None, 1]
    radius_ok = dx * dx + dy * dy <= rows[:, None, 5] * rows[:, None, 5]
    inside = ((pix[None, :, 0] >= rects[:, None, 0]) & (pix[None, :, 0] <= rects[:, None, 2])
              & (pix[None, :, 1] >= rects[:, None, 1]) & (pix[None, :, 1] <= rects[:, None, 3]))
    for name, keep in (("keep test", alpha > 0), ("radius test", radius_ok)):
        assert not bool((keep & ~inside).any()), (kind, name)
    assert bool((alpha > 0).any()) and bool((~inside).any())  # the case bites: some kept, some culled
    for footprint in (composite.FOOTPRINT, (16, 2)):
        pix_f, warp_f = _tile_pixels(footprint)
        xy_f = origin[:, None, :] + pix_f[None].float()
        alpha_f = gaussian_alpha(rows[:, None, 2:5], rows[:, None, :2], rows[:, None, 6], xy_f, rows[:, None, 5])
        bit = (composite.warp_masks(rects, footprint)[:, None] >> warp_f[None]) & 1
        assert not bool(((alpha_f > 0) & (bit == 0)).any()), (kind, footprint)


def test_entry_rects_whole_tile_past_the_cull_limit():
    rows = torch.zeros((4, 8))
    rows[:, 5] = 3.0
    rows[0, 5] = 2e6  # radius past the limit
    rows[1, 0] = -3e6  # mean past the limit
    rows[2, 1] = float("nan")
    rows[3, :2] = 100.0  # an ordinary entry far from the tile: empty rectangle
    rects = composite.entry_rects(rows, torch.zeros(4), torch.zeros(4))
    masks = composite.warp_masks(rects)
    assert masks[:3].tolist() == [(1 << WARPS) - 1] * 3
    assert int(masks[3]) == 0


@pytest.mark.parametrize("footprint", [composite.FOOTPRINT, (16, 2)])
def test_warp_masks_follow_the_pixel_layout(footprint):
    """A one-pixel rectangle meets exactly the warp that holds that pixel."""
    pix, warp = _tile_pixels(footprint)
    rects = torch.cat([pix, pix], -1).float()  # (x, y, x, y)
    masks = composite.warp_masks(rects, footprint)
    assert torch.equal(masks, torch.ones_like(masks) << warp)


def _walk(gfeat, colors, lists, image_shape, cull: bool):
    """One pixel after another, front to back, in float32: a plain model of the
    kernels' walk, skipping (warp, entry) pairs the masks leave out if `cull`."""
    b, _, c = colors.shape
    ntx, nty = lists.num_tiles_x, lists.num_tiles_y
    pix, warp = _tile_pixels()
    out = torch.zeros((b, nty * TILE, ntx * TILE, c))
    t_out = torch.ones((b, nty * TILE, ntx * TILE))
    for cell in range(lists.ranges.shape[0]):
        view, tile = divmod(cell, ntx * nty)
        ox, oy = (tile % ntx) * TILE, (tile // ntx) * TILE
        lo, hi = (int(v) for v in lists.ranges[cell])
        rows = gfeat[view, lists.idx[lo:hi].long()]
        cols = colors[view, lists.idx[lo:hi].long()]
        masks = composite.warp_masks(composite.entry_rects(rows, torch.full((hi - lo,), float(ox)), torch.full((hi - lo,), float(oy))))
        xy = pix.float() + torch.tensor([ox, oy], dtype=torch.float32)
        t = torch.ones(TILE * TILE)
        acc = torch.zeros((TILE * TILE, c))
        for j in range(hi - lo):
            alpha = gaussian_alpha(rows[j, 2:5], rows[j, :2], rows[j, 6], xy, rows[j, 5])
            walk = t >= 1e-4
            if cull:
                walk &= ((masks[j] >> warp) & 1) == 1
            alpha = torch.where(walk, alpha, torch.zeros_like(alpha))
            acc = acc + (alpha * t)[:, None] * cols[j][None]
            t = torch.where(alpha > 0, t * (1.0 - alpha), t)
        out[view, oy + pix[:, 1], ox + pix[:, 0]] = acc
        t_out[view, oy + pix[:, 1], ox + pix[:, 0]] = t
    h, w = image_shape
    return out[:, :h, :w], t_out[:, :h, :w]


@pytest.mark.parametrize("channels", [1, 3])
def test_culled_walk_changes_no_result(channels):
    """The walk with the warp cull gives the same bits as without it, and both
    agree with composite_tiles_plain (its chunked cumprod: 1e-5)."""
    image_shape = (40, 56)
    cams, gs = synthetic_scene(400, 2, "cpu", 5 + channels)
    gfeat, colors = binning.sort_by_depth(api.project_views(*cams[:2], cams[2], *gs, image_shape))
    colors = colors[..., :channels].contiguous()
    lists = binning.bin_gaussians(gfeat, image_shape)
    culled, t_culled = _walk(gfeat, colors, lists, image_shape, cull=True)
    full, t_full = _walk(gfeat, colors, lists, image_shape, cull=False)
    assert torch.equal(culled, full) and torch.equal(t_culled, t_full)
    bg = torch.zeros((2, channels))
    plain, t_plain, _ = composite.composite_tiles_plain(gfeat, colors, lists, bg, image_shape)
    np.testing.assert_allclose(culled.numpy(), plain.numpy(), atol=1e-5)
    np.testing.assert_allclose(t_culled.numpy(), t_plain.numpy(), atol=1e-5)


def test_tile_order_longest_first_and_stable():
    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 6, 300)  # many ties, empty cells
    ends = np.cumsum(lengths)
    ranges = torch.from_numpy(np.stack([ends - lengths, ends], 1).astype(np.int32))
    lists = binning.TileLists(torch.zeros(int(ends[-1]), dtype=torch.int32), ranges, 10, 15)
    order = composite.tile_order(lists)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(300))
    assert order.tolist() == np.argsort(-lengths, kind="stable").tolist()
    ordered = lengths[order.numpy()]
    assert (np.diff(ordered) <= 0).all()
    for v in np.unique(lengths):  # ties in cell order
        cells = order.numpy()[ordered == v]
        assert (np.diff(cells) > 0).all()


def test_report_counts_agree_with_the_plain_compositor():
    """raster_report's visited lengths sum to the plain compositor's
    evaluations; the keep test culls at least what the rectangle culls; the
    needed work lies inside the evaluations: kept pairs <= unculled ones, and
    the unculled ones are the evaluations less the rectangle's waste."""
    image_shape = (64, 80)
    cams, gs = synthetic_scene(1500, 2, "cpu", 1)
    gfeat, colors = binning.sort_by_depth(api.project_views(*cams[:2], cams[2], *gs, image_shape))
    lists = binning.bin_gaussians(gfeat, image_shape)
    work = raster_report.needed_work(gfeat, colors, lists)
    visited = work["visited"]
    _, _, evaluations = composite.composite_tiles_plain(gfeat, colors, lists, torch.zeros(2, 3), image_shape)
    lengths = lists.ranges[:, 1] - lists.ranges[:, 0]
    assert int(visited.sum()) * TILE * TILE == evaluations == work["evaluations"]
    assert bool((visited <= lengths).all())
    assert 0 < work["kept"] <= work["unculled"] < work["evaluations"]
    waste = raster_report.warp_waste(gfeat, lists, visited)
    assert waste["entries"] == lists.idx.shape[0]
    for name in raster_report.FOOTPRINTS:
        for suffix in ("", "_visited"):
            rect, exact = waste[f"rect_waste_{name}{suffix}"], waste[f"exact_waste_{name}{suffix}"]
            assert 0.0 <= rect <= exact <= 1.0, (name, suffix, rect, exact)
    assert 0.0 < waste["kept_share"] < 1.0
    assert work["unculled"] == pytest.approx(evaluations * (1.0 - waste["rect_waste_8x4_visited"]), rel=1e-9)
