"""The deterministic modes of K2 and K8 order their entries with no sort, on the CPU.

K2 (`bin_bwd(deterministic=True)`) adds each Gaussian's list entries in list
order; K8's sorted mode adds each d_value row's corners in corner order.
Both once took that order from `torch.sort(keys, stable=True)`; now it comes
from hand-written kernels (csrc/binning_bwd.cu `tp_bin_bwd_order`,
csrc/deform_vectors_bwd.cu `tp_deform_vectors_bwd_order`) whose plain
versions compute it arithmetically:

  * each plain order function (`bin_bwd_order_plain`,
    `vectors_bwd_order_plain`) equals torch.sort's permutation and segments
    exactly (`*_order_by_sort`), on request-like lists, dead-heavy and
    all-dead views, a grid wider than one shared-memory histogram, Gaussians
    over every tile, no pairs, corners outside the map and shapes drawn by
    hypothesis;
  * a numpy model of each kernel route, block by block as the kernels cut
    the work (K2: 4096-row scan blocks, a cell found per entry by a search
    of the cells' running ends; K8: 2048-corner chunks, cell slices, the
    count table, the scan in key order, per-warp cursors and 32-lane groups),
    gives the same order;
  * the plain deterministic K2 and K8 (order + in-order segment sums) agree
    with the JAX package's K2 (`bin_single_level`'s backward, the Pallas
    kernel in interpret mode) and K8 (`deform_sample_vectors` with
    impl="pallas" and "xla") on the same numpy inputs, within _torch_cases.py's
    GRAD_TOL: 1e-5 of the gradient's largest entry. The JAX K2 routes its
    cotangents through a two-way bf16 split (<= 2^-18 relative a value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from transplat_tpu.ops import deform as jax_deform
from transplat_tpu.ops.rasterizer import pallas_binning as jax_binning
from transplat_tpu_torch.ops import deform
from transplat_tpu_torch.ops.rasterizer import binning, projection

GRAD_TOL = 1e-5  # _torch_cases.py GRAD_TOL["bin"] and ["deform"]
DEAD = [1e9, 1e9, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]


def scaled(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# K2: lists and their order
# ---------------------------------------------------------------------------


def random_rows(views, g, shape, seed, dead_share=0.2):
    """Depth-sorted rows as sort_by_depth leaves them: means over and beyond
    the image, anisotropic conics, some opacities under 1/255, dead ones last."""
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
    rows[np.sort(rng.random((views, g)) < dead_share, axis=1)] = DEAD
    return rows


def request_rows(views, g, shape, seed):
    """Projected, depth-sorted Gaussians of a synthetic scene (_torch_cases.py's
    generator: a third needle-like) seen by `views` cameras."""
    from _torch_cases import synthetic_scene

    cams, gs = synthetic_scene(g, views, torch.device("cpu"), seed)
    with torch.no_grad():
        gfeat, colors = binning.sort_by_depth(projection.project_views(*cams[:2], cams[2], *gs, shape))
    return gfeat, colors


def k2_case(name):
    """(rows (B, G, 8), image shape, tile) of each named case."""
    if name == "request_like":
        return request_rows(4, 3000, (64, 64), 3)[0], (64, 64), 16
    if name == "dead_heavy_and_all_dead":
        rows = random_rows(3, 2 * binning.BWD_SCAN_ROWS // 3 + 7, (100, 76), 5, dead_share=0.9)
        rows[1] = DEAD
        return torch.from_numpy(rows), (100, 76), 16
    if name == "wider_than_a_histogram":  # 34 x 32 = 1088 tiles, more than K1's 1024
        return torch.from_numpy(random_rows(2, 900, (272, 256), 7)), (272, 256), 8
    if name == "cover_all":
        rows = random_rows(2, 500, (64, 96), 9)
        rows[:, 3] = [48.0, 32.0, 1e-6, 0.0, 1e-6, 1e4, 0.9, 0.0]
        return torch.from_numpy(rows), (64, 96), 16
    if name == "zero_pairs":
        rows = random_rows(2, 300, (48, 48), 11)
        rows[..., 5] = 0.0
        return torch.from_numpy(rows), (48, 48), 16
    if name == "many_scan_blocks":  # 3 x 4500 rows: the order's scan in several blocks
        return torch.from_numpy(random_rows(3, 4500, (40, 56), 13)), (40, 56), 8
    raise KeyError(name)


K2_CASES = ["request_like", "dead_heavy_and_all_dead", "wider_than_a_histogram", "cover_all", "zero_pairs",
            "many_scan_blocks"]


def k2_kernel_model(lists, views, g):
    """The order as csrc/binning_bwd.cu computes it, block by block: the areas'
    prefix inside BWD_SCAN_ROWS-row blocks plus the blocks' prefix; each
    entry's cell by a binary search of the cells' running list ends (an
    empty cell's range is (0, 0)); its place in its Gaussian's segment."""
    rects = binning.unpack_rects(lists.rects).reshape(views * g, 4).numpy().astype(np.int64)
    x0, y0, x1, y1 = rects.T
    area = np.where((x1 >= x0) & (y1 >= y0), (x1 - x0 + 1) * (y1 - y0 + 1), 0)
    rows, blk = views * g, binning.BWD_SCAN_ROWS
    nb = -(-rows // blk)
    padded = np.zeros(nb * blk, np.int64)
    padded[:rows] = area
    per_block = padded.reshape(nb, blk)
    local = (np.cumsum(per_block, 1) - per_block).reshape(-1)[:rows]
    prefix = np.cumsum(per_block.sum(1)) - per_block.sum(1)
    n = lists.idx.shape[0]
    offsets = np.append(local + prefix[np.arange(rows) // blk], n)
    cell_end = np.maximum.accumulate(lists.ranges[:, 1].numpy().astype(np.int64))
    k = np.arange(n)
    cell = np.searchsorted(cell_end, k, side="right")  # the first cell whose end exceeds k
    tiles, ntx = lists.num_tiles_x * lists.num_tiles_y, lists.num_tiles_x
    row = (cell // tiles) * g + lists.idx.numpy()
    t = cell % tiles
    place = offsets[row] + (t // ntx - y0[row]) * (x1[row] - x0[row] + 1) + (t % ntx - x0[row])
    perm = np.full(n, -1, np.int64)
    perm[place] = k
    return perm, offsets


def check_k2_order(gfeat, shape, tile):
    b, g, _ = gfeat.shape
    lists = binning.bin_gaussians(gfeat, shape, tile)  # CPU: the plain versions of K1's kernels
    ref_perm, ref_offsets = binning.bin_bwd_order_by_sort(lists, b, g)
    perm, offsets = binning.bin_bwd_order_plain(lists, b, g)
    assert perm.dtype == offsets.dtype == torch.int32
    assert torch.equal(perm, ref_perm) and torch.equal(offsets, ref_offsets)
    assert all(torch.equal(x, y) for x, y in zip(binning.bin_bwd_order(lists, b, g), (perm, offsets)))
    model_perm, model_offsets = k2_kernel_model(lists, b, g)
    assert np.array_equal(model_perm, ref_perm.numpy()) and np.array_equal(model_offsets, ref_offsets.numpy())
    return lists


@pytest.mark.parametrize("name", K2_CASES)
def test_k2_order_equals_the_stable_sort(name):
    gfeat, shape, tile = k2_case(name)
    lists = check_k2_order(gfeat, shape, tile)
    b, g, _ = gfeat.shape
    lengths = (lists.ranges[:, 1] - lists.ranges[:, 0]).reshape(b, -1).sum(1)
    if name == "zero_pairs":
        assert lists.idx.numel() == 0
    elif name == "dead_heavy_and_all_dead":
        assert int(lengths[1]) == 0 and int(lengths.sum()) > 0
    elif name == "cover_all":
        assert int(((lists.ranges[:, 1] - lists.ranges[:, 0]) > 0).sum()) == lists.ranges.shape[0]


@pytest.mark.parametrize("name", K2_CASES)
def test_k2_in_order_sums_equal_index_add_bit_for_bit(name):
    """On the CPU index_add_ adds each Gaussian's entries in list order too:
    the sorted route's plain sums give its bits, through bin_bwd as well."""
    gfeat, shape, tile = k2_case(name)
    b, g, _ = gfeat.shape
    lists = binning.bin_gaussians(gfeat, shape, tile)
    rng = np.random.default_rng(len(name))
    for c in (3, 5):
        d_pair = torch.from_numpy(rng.standard_normal((lists.idx.shape[0], binning.pair_width(c))).astype(np.float32))
        got = binning.split_rows(binning.bin_bwd_sorted(d_pair, *binning.bin_bwd_order(lists, b, g)), b, g, c)
        ref = binning.bin_bwd_plain(d_pair, lists, b, g, c)
        assert all(torch.equal(x, y) for x, y in zip(got, ref))


def test_k2_order_needs_the_lists_rectangles():
    gfeat, shape, tile = k2_case("zero_pairs")
    lists = binning.bin_gaussians(gfeat, shape, tile)
    with pytest.raises(ValueError, match="rectangles"):
        binning.bin_bwd_order(lists._replace(rects=None), *gfeat.shape[:2])


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(views=st.integers(1, 3), g=st.integers(1, 700), h=st.integers(8, 90), w=st.integers(8, 90),
       tile=st.sampled_from([8, 16]), dead=st.floats(0.0, 1.0), seed=st.integers(0, 2**31 - 1))
def test_k2_order_equals_the_stable_sort_on_drawn_shapes(views, g, h, w, tile, dead, seed):
    check_k2_order(torch.from_numpy(random_rows(views, g, (h, w), seed, dead_share=dead)), (h, w), tile)


# ---------------------------------------------------------------------------
# K8: corner keys and their order
# ---------------------------------------------------------------------------

SORT_CHUNK, SORT_WARPS, MAX_SLICE_CELLS = 2048, 8, 6144  # kSortChunk, kSortWarps, kMaxSliceCells


def vectors_case(n, q, p, h, w, c, seed, lo=-0.2, hi=1.2, far=0):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((n, h * w, c)).astype(np.float32)
    loc = rng.uniform(lo, hi, (n, q, p, 2)).astype(np.float32)
    loc[:, :far] *= 1e6  # every corner outside the map
    aw = rng.random((n, q, p)).astype(np.float32)
    aw /= aw.sum(-1, keepdims=True)
    cot = rng.standard_normal((n, q, c)).astype(np.float32)
    return value, loc, aw, cot


def k8_kernel_model(keys, n_batch, hw):
    """The counting sort as csrc/deform_vectors_bwd.cu runs it: a block per
    (batch entry, chunk of SORT_CHUNK corners, slice of the HW + 1 cells);
    the count table (n, chunk, cell); each (n, cell) row's prefix over the
    chunks; row starts in key order (map cells of every n, then the outside
    cells); per block, each warp's count per cell, cursors from the row start
    + the chunk prefix + the earlier warps' counts, and each warp's corners
    32 at a time, a lane at its cursor plus the lower lanes of its cell."""
    keys = keys.numpy().astype(np.int64)
    e = keys.shape[0]
    per = e // n_batch
    cells = hw + 1
    chunks = -(-per // SORT_CHUNK)
    slices = -(-cells // MAX_SLICE_CELLS)
    slice_cells = -(-cells // slices)
    n_of = np.arange(e) // per
    cell = np.where(keys == n_batch * hw, hw, keys - n_of * hw)
    chunk = (np.arange(e) - n_of * per) // SORT_CHUNK
    table = np.zeros((n_batch, chunks, cells), np.int64)
    np.add.at(table, (n_of, chunk, cell), 1)
    bases = np.cumsum(table, 1) - table
    totals = table.sum(1)  # (n, cells)
    order = np.concatenate([totals[:, :hw].reshape(-1), totals[:, hw]])
    starts = np.cumsum(order) - order
    row_start = np.empty((n_batch, cells), np.int64)
    row_start[:, :hw] = starts[: n_batch * hw].reshape(n_batch, hw)
    row_start[:, hw] = starts[n_batch * hw :]
    offsets = np.append(starts[: n_batch * hw + 1], e)
    perm = np.full(e, -1, np.int64)
    per_warp = SORT_CHUNK // SORT_WARPS
    for n in range(n_batch):
        for ch in range(chunks):
            e0, e1 = n * per + ch * SORT_CHUNK, n * per + min(per, (ch + 1) * SORT_CHUNK)
            for s in range(slices):
                c0, c1 = s * slice_cells, min(cells, (s + 1) * slice_cells)
                runs = [(min(e1, e0 + wp * per_warp), min(e1, e0 + (wp + 1) * per_warp)) for wp in range(SORT_WARPS)]
                counts = np.zeros((SORT_WARPS, c1 - c0), np.int64)
                for wp, (w0, w1) in enumerate(runs):
                    mine = cell[w0:w1]
                    np.add.at(counts[wp], mine[(mine >= c0) & (mine < c1)] - c0, 1)
                cursor = row_start[n, c0:c1] + bases[n, ch, c0:c1] + np.cumsum(counts, 0) - counts
                for wp, (w0, w1) in enumerate(runs):
                    for base in range(w0, w1, 32):
                        lanes = np.arange(base, min(w1, base + 32))
                        lc = cell[lanes]
                        inside = (lc >= c0) & (lc < c1)
                        for i in np.nonzero(inside)[0]:
                            lower = np.count_nonzero(lc[:i] == lc[i])
                            perm[cursor[wp, lc[i] - c0] + lower] = lanes[i]
                        for v in np.unique(lc[inside]):
                            cursor[wp, v - c0] += np.count_nonzero(lc == v)
    return perm, offsets


K8_CASES = {
    # name: n, q, p, h, w, lo, hi, far
    "self_attention_like": (2, 256, 4, 16, 16, -0.05, 1.05, 0),
    "outside_the_map": (2, 64, 4, 16, 16, -0.6, 1.6, 8),
    "every_corner_outside": (1, 20, 3, 5, 7, 0.0, 1.0, 20),
    "more_than_one_chunk": (3, 700, 1, 9, 13, -0.1, 1.1, 5),
    "wider_than_a_histogram": (1, 600, 4, 80, 80, -0.1, 1.1, 3),  # 6401 cells: two slices
}


def k8_keys(name):
    n, q, p, h, w, lo, hi, far = K8_CASES[name]
    _, loc, aw, _ = vectors_case(n, q, p, h, w, 4, seed=q + p, lo=lo, hi=hi, far=far)
    keys, corner_w = deform.vectors_bwd_keys_plain(torch.from_numpy(loc), torch.from_numpy(aw), h, w)
    return keys, corner_w, n, h * w


@pytest.mark.parametrize("name", list(K8_CASES))
def test_k8_order_equals_the_stable_sort(name):
    keys, _, n, hw = k8_keys(name)
    ref_perm, ref_offsets = deform.vectors_bwd_order_by_sort(keys, n * hw)
    perm, offsets = deform.vectors_bwd_order_plain(keys, n * hw)
    assert perm.dtype == offsets.dtype == torch.int32
    assert torch.equal(perm, ref_perm) and torch.equal(offsets, ref_offsets)
    assert all(torch.equal(x, y) for x, y in zip(deform.vectors_bwd_order(keys, n, hw), (perm, offsets)))
    model_perm, model_offsets = k8_kernel_model(keys, n, hw)
    assert np.array_equal(model_perm, ref_perm.numpy()) and np.array_equal(model_offsets, ref_offsets.numpy())
    outside = int((keys == n * hw).sum())
    assert int(offsets[-1] - offsets[-2]) == outside  # the last segment: the corners outside the map
    if name == "every_corner_outside":
        assert outside == keys.shape[0]


def test_k8_order_of_no_corners():
    keys = torch.zeros(0, dtype=torch.int32)
    perm, offsets = deform.vectors_bwd_order_plain(keys, 2 * 12)
    assert perm.numel() == 0 and torch.equal(offsets, torch.zeros(2 * 12 + 2, dtype=torch.int32))


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(n=st.integers(1, 3), q=st.integers(1, 300), p=st.integers(1, 4), h=st.integers(1, 12), w=st.integers(1, 12),
       spread=st.floats(0.0, 1.0), seed=st.integers(0, 2**31 - 1))
def test_k8_order_equals_the_stable_sort_on_drawn_shapes(n, q, p, h, w, spread, seed):
    _, loc, aw, _ = vectors_case(n, q, p, h, w, 1, seed, lo=-spread, hi=1.0 + spread)
    keys, _ = deform.vectors_bwd_keys_plain(torch.from_numpy(loc), torch.from_numpy(aw), h, w)
    ref = deform.vectors_bwd_order_by_sort(keys, n * h * w)
    assert all(torch.equal(x, y) for x, y in zip(deform.vectors_bwd_order_plain(keys, n * h * w), ref))
    model = k8_kernel_model(keys, n, h * w)
    assert np.array_equal(model[0], ref[0].numpy()) and np.array_equal(model[1], ref[1].numpy())


# ---------------------------------------------------------------------------
# The plain deterministic K2 and K8 against the JAX package
# ---------------------------------------------------------------------------


def jax_k2(gfeat, colors, lists, d_pair, shape, tile):
    """JAX's K2 on the port's list-entry gradients: `bin_single_level`'s
    worklists hold, per tile, the Gaussians that cover it in depth order (the
    port's lists), so d_pair's rows go into its cotangent at the same places
    and the backward of the Pallas routing (interpret mode) returns
    per-Gaussian rows (7 + C, G): mean, conic, radius, opacity, colours."""
    b, g, _ = gfeat.shape
    c = colors.shape[-1]
    ntx, nty = lists.num_tiles_x, lists.num_tiles_y
    cg = 128
    window = -(-g // cg) * cg
    feat = np.concatenate([gfeat.numpy()[..., :7], colors.numpy()], -1).transpose(0, 2, 1)
    feat = np.pad(feat, ((0, 0), (0, 0), (0, window - g)))  # radius 0: covers nothing
    ranges = lists.ranges.numpy()
    lengths = ranges[:, 1] - ranges[:, 0]
    capacity = max(128, -(-int(lengths.max()) // 128) * 128)
    fwd = lambda f: jax_binning.bin_single_level(f, tile, ntx, nty, capacity, cg, window, True, 7 + c)[0]  # noqa: E731
    gdat, vjp = jax.vjp(fwd, jnp.asarray(feat))
    assert np.array_equal(np.asarray(jnp.sum(gdat[:, 5] > 0, axis=1)), lengths)  # the same lists
    dg = np.zeros(gdat.shape, np.float32)
    rows = d_pair.numpy()
    for cell, (s, e) in enumerate(ranges):
        dg[cell, :7, : e - s] = rows[s:e, :7].T
        dg[cell, 7 : 7 + c, : e - s] = rows[s:e, 8 : 8 + c].T
    (d_feat,) = vjp(jnp.asarray(dg))
    return np.asarray(d_feat)[..., :g]


@pytest.mark.parametrize("name,channels", [("request_like", 3), ("dead_heavy", 5)])
def test_plain_deterministic_k2_matches_jax(name, channels):
    shape, tile = (48, 64), 16
    if name == "request_like":
        gfeat = request_rows(2, 400, shape, 17)[0]
    else:
        rows = random_rows(3, 300, shape, 19, dead_share=0.8)
        rows[1] = DEAD
        gfeat = torch.from_numpy(rows)
    b, g, _ = gfeat.shape
    rng = np.random.default_rng(channels)
    colors = torch.from_numpy(rng.uniform(0, 1, (b, g, channels)).astype(np.float32))
    lists = binning.bin_gaussians(gfeat, shape, tile)
    d_pair = np.zeros((lists.idx.shape[0], binning.pair_width(channels)), np.float32)
    d_pair[:, :7] = rng.standard_normal((d_pair.shape[0], 7))
    d_pair[:, 8 : 8 + channels] = rng.standard_normal((d_pair.shape[0], channels))
    d_pair = torch.from_numpy(d_pair)
    d_feat = binning.bin_bwd_sorted_plain(d_pair, *binning.bin_bwd_order_plain(lists, b, g))
    d_gfeat, d_colors = binning.split_rows(d_feat, b, g, channels)
    ref = jax_k2(gfeat, colors, lists, d_pair, shape, tile)
    assert scaled(d_gfeat[..., :7].numpy().transpose(0, 2, 1), ref[:, :7]) <= GRAD_TOL
    assert scaled(d_colors.numpy().transpose(0, 2, 1), ref[:, 7:]) <= GRAD_TOL
    assert float(d_gfeat[..., 7].abs().max()) == 0.0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", ["self_attention_like", "outside_the_map"])
def test_plain_deterministic_k8_matches_jax(name, impl):
    n, q, p, h, w, lo, hi, far = K8_CASES[name]
    c = 128  # shapes the TPU kernel takes: 64 or 256 queries of a 16x16 map, C 128
    value, loc, aw, cot = vectors_case(n, q, p, h, w, c, seed=7, lo=lo, hi=hi, far=far)
    got = deform.deform_sample_vectors_bwd_sorted_plain(
        torch.from_numpy(value), (h, w), torch.from_numpy(loc), torch.from_numpy(aw), torch.from_numpy(cot)
    )
    fn = lambda v, l, a: jax_deform.deform_sample_vectors(v, (h, w), l, a, impl=impl)  # noqa: E731
    ref = jax.grad(lambda v, l, a: jnp.sum(jax.vmap(fn)(v, l, a) * cot), argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(aw)
    )
    for label, a, r in zip(("value", "loc", "weights"), got, ref):
        assert a.shape == r.shape and scaled(a.numpy(), r) <= GRAD_TOL, (label, scaled(a.numpy(), r))
    if far:
        assert float(got[1][:, :far].abs().max()) == 0.0 and float(got[2][:, :far].abs().max()) == 0.0
