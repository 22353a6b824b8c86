"""K1's sort-free tile lists (count, scan, place; csrc/binning.cu) on the CPU.

  * A numpy model of the three kernels, block by block as they run: the
    kernel's chunk of depth-sorted Gaussians per block, tile slices where a
    view has more tiles than one shared-memory histogram holds, a cursor per
    warp and tile, each warp's Gaussians 32 at a time with a lane mask per
    tile. Its lists equal bin_gaussians_plain's (a key per pair and a stable
    sort), bit for bit, as do those of the port's bin_gaussians (whose
    wrappers run their plain versions here).
  * The per-(tile, chunk) bases of the scan equal JAX's `chunk_bases`
    (transplat_tpu/ops/rasterizer/pallas_binning.py) on the same rows and
    chunk size.
  * Each tile's list equals JAX's sort-free `bin_gaussians_fast`
    (transplat_tpu/ops/rasterizer/tiles.py) at a capacity with no overflow,
    on Gaussians whose cull radius is their radius (the JAX function bins
    the radius rectangle).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transplat_tpu.ops.rasterizer import pallas_binning as jax_binning
from transplat_tpu.ops.rasterizer import tiles as jax_tiles
from transplat_tpu.ops.rasterizer.projection import ProjectedGaussians as JaxProjected
from transplat_tpu_torch.ops.rasterizer import binning
from transplat_tpu_torch.ops.rasterizer.projection import ProjectedGaussians

CHUNK = binning.BIN_CHUNK
WARPS, MAX_SLICE_TILES, STAGED = 8, 1024, 4096  # kWarps, kMaxSliceTiles, kStaged in csrc/binning.cu
PER_WARP = CHUNK // WARPS
DEAD = [1e9, 1e9, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]


def random_rows(views, g, shape, seed):
    """Depth-sorted rows as sort_by_depth leaves them: means over and beyond
    the image, anisotropic conics, opacities on both sides of 1/255, a fifth
    dead (radius 0, means 1e9) and the dead ones last."""
    rng = np.random.default_rng(seed)
    h, w = shape
    rows = np.zeros((views, g, 8), np.float32)
    rows[..., 0] = rng.uniform(-20, w + 20, (views, g))
    rows[..., 1] = rng.uniform(-20, h + 20, (views, g))
    s = rng.uniform(0.5, 10.0, (views, g))
    stretch = rng.uniform(1.0, 4.0, (views, g))
    rows[..., 2] = 1.0 / (s * stretch) ** 2
    rows[..., 3] = rng.uniform(-0.2, 0.2, (views, g)) / s**2
    rows[..., 4] = 1.0 / s**2
    rows[..., 5] = 3.0 * s * stretch
    rows[..., 6] = rng.uniform(0.0, 1.0, (views, g)) * np.where(rng.random((views, g)) < 0.2, 0.01, 1.0)
    dead = np.sort(rng.random((views, g)) < 0.2, axis=1)  # dead ones last
    rows[dead] = DEAD
    return rows


CASES = {
    # name: views, Gaussians, image, tile
    "one_view_tile16": (1, 2 * CHUNK + 37, (100, 76), 16),
    "two_views_ragged": (2, 3 * CHUNK - 1, (48, 64), 16),
    "three_views_tile8": (3, CHUNK + 5, (64, 80), 8),
    "four_views_tile8": (4, 700, (40, 56), 8),
    "wider_than_a_histogram": (1, 900, (272, 256), 8),  # 34 x 32 = 1088 tiles: two slices
    "dead_view": (3, CHUNK + 100, (64, 64), 16),
    "cover_all": (2, 500, (64, 96), 16),
    "zero_pairs": (2, 300, (48, 48), 16),
}


def case_rows(name):
    views, g, shape, tile = CASES[name]
    rows = random_rows(views, g, shape, seed=len(name) + g)
    if name == "dead_view":
        rows[1] = DEAD
    elif name == "cover_all":
        rows[:, 3] = [shape[1] / 2, shape[0] / 2, 1e-6, 0.0, 1e-6, 1e4, 0.9, 0.0]  # a Gaussian over every tile
    elif name == "zero_pairs":
        rows[..., 5] = 0.0
    return torch.from_numpy(rows), shape, tile


# ---------------------------------------------------------------------------
# The numpy model of the kernels
# ---------------------------------------------------------------------------


def tile_slices(tiles):
    """The grid's third dimension: slices of at most MAX_SLICE_TILES tiles."""
    n = -(-tiles // MAX_SLICE_TILES)
    per = -(-tiles // n)
    return [(z * per, min(tiles, z * per + per)) for z in range(n)]


def tiles_in(rect, ntx, t0, t1):
    """for_tiles: the rectangle's tiles in [t0, t1), in increasing order, as t - t0."""
    x0, y0, x1, y1 = rect
    out = []
    for ty in range(max(y0, t0 // ntx), min(y1, (t1 - 1) // ntx) + 1):
        row = ty * ntx
        out += [row + tx - t0 for tx in range(max(x0, t0 - row), min(x1, t1 - 1 - row) + 1)]
    return out


def model_lists(rows, shape, tile):
    """idx and ranges as count, scan and place build them."""
    views, g, _ = rows.shape
    ntx, nty = binning.grid_size(shape, tile)
    tiles, chunks = ntx * nty, -(-g // CHUNK)
    rects = binning.bin_rects_plain(rows, ntx, nty, tile)[0].numpy()  # the kernel's float32 arithmetic
    # Count: a block per (view, chunk, slice), a histogram of its slice.
    table = np.zeros((views, tiles, chunks), np.int64)
    for v in range(views):
        for c in range(chunks):
            for t0, t1 in tile_slices(tiles):
                for rank in range(c * CHUNK, min(g, (c + 1) * CHUNK)):
                    for s in tiles_in(rects[v, rank], ntx, t0, t1):
                        table[v, t0 + s, c] += 1
    # Scan: each row's exclusive prefix over the chunks, then the rows' starts.
    bases = np.cumsum(table, axis=2) - table
    totals = table.sum(axis=2).reshape(-1)
    starts = np.cumsum(totals) - totals
    ranges = np.where(totals[:, None] > 0, np.stack([starts, starts + totals], 1), 0)
    total = int(totals.sum())
    # Place: per block, warps' cursors after the earlier warps' counts, lanes by mask.
    idx = np.full(total, -1, np.int64)
    for v in range(views):
        for c in range(chunks):
            for t0, t1 in tile_slices(tiles):
                cursor = np.zeros((WARPS, t1 - t0), np.int64)
                first = [c * CHUNK + w * PER_WARP for w in range(WARPS)]
                for w in range(WARPS):
                    for rank in range(first[w], min(g, first[w] + PER_WARP)):
                        for s in tiles_in(rects[v, rank], ntx, t0, t1):
                            cursor[w, s] += 1
                counts = cursor.sum(axis=0)
                local = np.cumsum(counts) - counts  # block positions, tile after tile
                cells = v * tiles + t0 + np.arange(t1 - t0)
                offset = ranges[cells, 0] + bases[v, t0:t1, c] - local
                cursor = local + np.cumsum(cursor, axis=0) - cursor
                # (Up to STAGED pairs the block gathers them before writing; the places are the same.)
                for w in range(WARPS):
                    for k0 in range(first[w], min(g, first[w] + PER_WARP), 32):
                        lanes = range(k0, min(g, k0 + 32))
                        masks = {}
                        for lane, rank in enumerate(lanes):
                            for s in tiles_in(rects[v, rank], ntx, t0, t1):
                                masks[s] = masks.get(s, 0) | 1 << lane
                        for lane, rank in enumerate(lanes):
                            for s in tiles_in(rects[v, rank], ntx, t0, t1):
                                at = cursor[w, s] + bin(masks[s] & ((1 << lane) - 1)).count("1")
                                assert idx[offset[s] + at] == -1  # every place is taken once
                                idx[offset[s] + at] = rank
                        for s, m in masks.items():
                            cursor[w, s] += bin(m).count("1")
    assert (idx >= 0).all()
    return idx, ranges, table


@pytest.mark.parametrize("name", list(CASES))
def test_count_and_place_model_equals_the_sorted_route(name):
    rows, shape, tile = case_rows(name)
    idx, ranges, table = model_lists(rows, shape, tile)
    ref = binning.bin_gaussians_plain(rows, shape, tile)
    assert torch.equal(torch.from_numpy(idx).to(torch.int32), ref.idx)
    assert torch.equal(torch.from_numpy(ranges).to(torch.int32), ref.ranges)
    # The port's wrappers (their plain versions on the CPU) agree with the model piece by piece.
    ntx, nty = binning.grid_size(shape, tile)
    count, rects, aux = binning.bin_count(rows, ntx, nty, tile)
    assert torch.equal(count, torch.from_numpy(table).to(torch.int32))
    plain_rects, plain_counts = binning.bin_rects_plain(rows, ntx, nty, tile)
    empty = torch.tensor([1, 0, 0, 0], dtype=torch.int32)  # how a packed empty rectangle unpacks
    assert torch.equal(binning.unpack_rects(rects), torch.where(plain_counts[..., None] > 0, plain_rects, empty))
    lists = binning.bin_gaussians(rows, shape, tile)
    assert torch.equal(lists.idx, ref.idx) and torch.equal(lists.ranges, ref.ranges)
    if name == "zero_pairs":
        assert ref.idx.numel() == 0
    if name == "dead_view":
        assert int((ref.ranges.reshape(3, -1, 2)[1]).abs().sum()) == 0
    if name == "cover_all":
        counts = (ref.ranges[:, 1] - ref.ranges[:, 0]).reshape(2, -1)
        assert bool((counts > 0).all())
    if name == "wider_than_a_histogram":
        assert len(tile_slices(ntx * nty)) == 2


@pytest.mark.parametrize("name", ["one_view_tile16", "two_views_ragged", "three_views_tile8", "dead_view"])
def test_scan_bases_equal_jax_chunk_bases(name):
    rows, shape, tile = case_rows(name)
    views, g, _ = rows.shape
    ntx, nty = binning.grid_size(shape, tile)
    table, _, aux = binning.bin_count(rows, ntx, nty, tile)
    ranges = binning.bin_scan(table, aux)
    chunks = table.shape[-1]
    padded = np.concatenate([rows.numpy(), np.tile(np.float32(DEAD), (views, chunks * CHUNK - g, 1))], axis=1)
    t = np.arange(ntx * nty)
    tx0 = jnp.asarray((t % ntx * tile).astype(np.float32))
    ty0 = jnp.asarray((t // ntx * tile).astype(np.float32))
    bases = np.asarray(jax_binning.chunk_bases(jnp.asarray(padded.transpose(0, 2, 1)), tx0, ty0, (tile, tile), CHUNK))
    np.testing.assert_array_equal(table.numpy(), bases[..., :chunks])
    np.testing.assert_array_equal((ranges[:, 1] - ranges[:, 0]).reshape(views, -1).numpy(), bases[..., chunks])
    assert int(aux[0]) == int(bases[..., chunks].sum())


@pytest.mark.parametrize("g,shape,tile", [(700, (64, 80), 16), (400, (40, 56), 8), (1500, (100, 76), 16)])
def test_tile_lists_equal_jax_bin_gaussians_fast(g, shape, tile):
    """One view of isotropic Gaussians at opacity 0.99, whose cull radius
    sqrt(2 ln(255 op) sigma^2) > 3 sigma is their radius 3 sigma: the
    rectangle the JAX function bins. Lists as original indices."""
    rng = np.random.default_rng(g)
    h, w = shape
    sigma = rng.uniform(0.3, 6.0, g).astype(np.float32)
    fields = dict(
        mean2d=np.stack([rng.uniform(-15, w + 15, g), rng.uniform(-15, h + 15, g)], 1).astype(np.float32),
        depth=rng.permutation(g).astype(np.float32) + 1.0,  # distinct depths
        conic=np.stack([1 / sigma**2, np.zeros(g), 1 / sigma**2], 1).astype(np.float32),
        radius=np.where(rng.random(g) < 0.1, 0.0, 3.0 * sigma).astype(np.float32),
        rgb=rng.random((g, 3)).astype(np.float32),
        opacity=np.full(g, 0.99, np.float32),
        valid=rng.random(g) > 0.05,
    )
    proj = ProjectedGaussians(**{k: torch.from_numpy(np.asarray(v))[None] for k, v in fields.items()})
    gfeat, _ = binning.sort_by_depth(proj)
    lists = binning.bin_gaussians(gfeat, shape, tile)
    live = proj.valid[0] & (proj.radius[0] > 0)
    order = torch.argsort(torch.where(live, proj.depth[0], torch.inf), stable=True)
    ntx, nty = binning.grid_size(shape, tile)
    ref = jax_tiles.bin_gaussians_fast(JaxProjected(**{k: jnp.asarray(v) for k, v in fields.items()}), shape,
                                       tile_size=tile, capacity=g, tile_chunk=ntx * nty)
    assert int(ref.overflow) == 0
    indices, mask = np.asarray(ref.indices), np.asarray(ref.mask)
    for t, (start, end) in enumerate(lists.ranges.tolist()):
        np.testing.assert_array_equal(order[lists.idx[start:end].long()].numpy(), indices[t][mask[t]])
