"""Tile binning (K1) and its transpose (K2).

Counterpart of transplat_tpu/ops/rasterizer/pallas_binning.py
(`build_sorted_features`, `cull_radii`, `chunk_bases`, `_bin_fwd_kernel`,
`_bin_bwd_kernel`). The port builds index lists plus per-tile [start, end)
ranges instead of routed feature copies, with no capacity and nothing
dropped: three kernels count each chunk's pairs per tile, scan the counts
and place every pair, with no sort (csrc/binning.cu says how). `bin_bwd` adds
the list entries' gradients back into per-Gaussian rows
(csrc/binning_bwd.cu): with atomics, or (deterministic) Gaussian by
Gaussian in list order, in the order `bin_bwd_order` reads off K1's packed
rectangles, again with no sort. Gradient rows are `pair_width(C)` wide: the
8 geometry columns and the C colours zero-padded to whole 16-byte vectors.

Each kernel has a wrapper that launches it for CUDA tensors and runs its
plain PyTorch version (same function, `*_plain`) for CPU tensors.
`bin_gaussians_plain` builds the same lists another way (one key per pair,
a stable sort, the runs' ends), as the reference the kernels are held to;
`bin_bwd_order_by_sort` does the same for K2's order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ... import kernels
from .projection import (
    CONIC_A,
    CONIC_B,
    CONIC_C,
    GFEAT_WIDTH,
    MEAN_X,
    MEAN_Y,
    OPACITY,
    RADIUS,
    ProjectedGaussians,
    depth_keys,
    geometry_rows,
    live_mask,
)


class TileLists(NamedTuple):
    idx: torch.Tensor  # (N,) int32 depth-sorted Gaussian index of each pair, tile-major
    ranges: torch.Tensor  # (B * T, 2) int32 [start, end) of each (view, tile) in idx
    num_tiles_x: int
    num_tiles_y: int
    # (B, G, 2) int32: each Gaussian's cull rectangle packed as bin_count
    # writes it (pack_rects); they give K2's deterministic order.
    rects: torch.Tensor | None = None


def gather_rows(order: torch.Tensor, rows: torch.Tensor, color: torch.Tensor):
    """Rows (B, G, 8) and colours (B, G, C) in the order (B, G)."""
    if color.shape[-1] > 8:
        raise ValueError(f"at most 8 colour channels, got {color.shape[-1]}")
    gfeat = torch.take_along_dim(rows, order[..., None], dim=1).contiguous()
    colors = torch.take_along_dim(color, order[..., None], dim=1).contiguous()
    return gfeat, colors


def sort_rows(keys: torch.Tensor, rows: torch.Tensor, color: torch.Tensor):
    """Keys (B, G), rows (B, G, 8) and colours (B, G, C) -> the rows and
    colours in the keys' order, sorted stably (ties keep their original
    order, as JAX's stable sort does)."""
    return gather_rows(torch.argsort(keys, dim=-1, stable=True), rows, color)


def sort_by_depth(proj: ProjectedGaussians, feature: torch.Tensor | None = None):
    """Projected Gaussians -> depth-sorted (B, G, 8) geometry rows and (B, G, C) colours.

    Live Gaussians (valid, radius > 0) first, by depth, stably; dead ones
    last with radius and opacity 0 and their means at 1e9. The order comes
    before the rows are built, so the sort's scratch is freed before the
    rows are allocated."""
    live = live_mask(proj)
    order = torch.argsort(depth_keys(proj, live), dim=-1, stable=True)
    return gather_rows(order, geometry_rows(proj, live), proj.rgb if feature is None else feature)


def grid_size(image_shape: tuple[int, int], tile: int) -> tuple[int, int]:
    h, w = image_shape
    return (w + tile - 1) // tile, (h + tile - 1) // tile


# ---------------------------------------------------------------------------
# Tile rectangles under the exact significance cull
# ---------------------------------------------------------------------------


def cull_radii(gfeat: torch.Tensor):
    """Per-axis significance radii (rx, ry) of `cull_radii` in pallas_binning.py:
    |dx| <= sqrt(2 ln(255 op) Sigma_xx) (+1e-3 margin on tau), capped by the
    radius; 0 for Gaussians that can never reach alpha 1/255."""
    a, b, c = gfeat[..., CONIC_A], gfeat[..., CONIC_B], gfeat[..., CONIC_C]
    r, op = gfeat[..., RADIUS], gfeat[..., OPACITY]
    det = torch.clamp(a * c - b * b, min=1e-20)
    tau = 2.0 * torch.log(torch.clamp(op, min=1e-20) * 255.0) + 1e-3
    tau = torch.clamp(tau, min=0.0)
    rx = torch.minimum(torch.sqrt(torch.clamp(tau * c, min=0.0) / det), r)
    ry = torch.minimum(torch.sqrt(torch.clamp(tau * a, min=0.0) / det), r)
    keep = (r > 0.0) & (op * 255.0 >= 1.0 - 1e-3)
    zero = torch.zeros_like(r)
    return torch.where(keep, rx, zero), torch.where(keep, ry, zero)


def bin_rects_plain(gfeat: torch.Tensor, ntx: int, nty: int, tile: int):
    """(B, G, 8) -> rects (B, G, 4) int32 inclusive (x0, y0, x1, y1) and counts (B, G) int32."""
    rx, ry = cull_radii(gfeat)
    mx, my = gfeat[..., MEAN_X], gfeat[..., MEAN_Y]
    ft = float(tile)
    x0 = torch.clamp(torch.floor((mx - rx) / ft), 0.0, float(ntx))
    x1 = torch.clamp(torch.floor((mx + rx) / ft), -1.0, float(ntx - 1))
    y0 = torch.clamp(torch.floor((my - ry) / ft), 0.0, float(nty))
    y1 = torch.clamp(torch.floor((my + ry) / ft), -1.0, float(nty - 1))
    ok = (rx > 0.0) & (x1 >= x0) & (y1 >= y0)
    rects = torch.stack([x0, y0, x1, y1], dim=-1).to(torch.int32)
    rects = torch.where(ok[..., None], rects, torch.tensor([0, 0, -1, -1], dtype=torch.int32, device=gfeat.device))
    counts = torch.where(ok, (rects[..., 2] - rects[..., 0] + 1) * (rects[..., 3] - rects[..., 1] + 1), 0)
    return rects, counts.to(torch.int32)


# ---------------------------------------------------------------------------
# The reference route: one (view * T + tile) key per pair, a stable sort
# ---------------------------------------------------------------------------


def _pairs_of_rects(rects: torch.Tensor, ntx: int, nty: int):
    """rects (B, G, 4) inclusive tile rectangles (x1 < x0 where empty) ->
    every (Gaussian, covered tile) pair in Gaussian order, the tiles of a
    Gaussian in row-major order: keys (N,) int64 view * T + tile and vals
    (N,) int64 the Gaussian's depth-sorted rank."""
    g = rects.shape[1]
    r = rects.reshape(-1, 4).to(torch.int64)
    n = torch.clamp(r[:, 2] - r[:, 0] + 1, min=0) * torch.clamp(r[:, 3] - r[:, 1] + 1, min=0)
    total = int(n.sum())
    gid = torch.repeat_interleave(torch.arange(n.shape[0], device=n.device), n, output_size=total)
    j = torch.arange(total, device=n.device) - (torch.cumsum(n, 0) - n)[gid]
    width = (r[:, 2] - r[:, 0] + 1)[gid]
    tx = r[gid, 0] + j % width
    ty = r[gid, 1] + j // width
    return (gid // g) * (ntx * nty) + ty * ntx + tx, gid % g


def bin_ranges_plain(keys_sorted: torch.Tensor, num_cells: int) -> torch.Tensor:
    """(num_cells, 2) int32 [start, end) of each cell's run; (0, 0) for an empty cell."""
    cells = torch.arange(num_cells, dtype=keys_sorted.dtype, device=keys_sorted.device)
    start = torch.searchsorted(keys_sorted, cells, right=False)
    end = torch.searchsorted(keys_sorted, cells, right=True)
    ranges = torch.stack([start, end], dim=-1)
    return torch.where((end > start)[:, None], ranges, 0).to(torch.int32)


def bin_gaussians_plain(gfeat: torch.Tensor, image_shape: tuple[int, int], tile: int = 16) -> TileLists:
    """The lists the kernels build, by the classic route: a key per pair, a
    stable sort by key (each tile's run stays in depth order), each run's ends."""
    ntx, nty = grid_size(image_shape, tile)
    rects = bin_rects_plain(gfeat, ntx, nty, tile)[0]
    keys, vals = _pairs_of_rects(rects, ntx, nty)
    keys_sorted, perm = torch.sort(keys, stable=True)
    idx = vals[perm].to(torch.int32)
    return TileLists(idx=idx, ranges=bin_ranges_plain(keys_sorted, gfeat.shape[0] * ntx * nty),
                     num_tiles_x=ntx, num_tiles_y=nty, rects=pack_rects(rects))


# ---------------------------------------------------------------------------
# K1: count, scan, place (csrc/binning.cu)
# ---------------------------------------------------------------------------

# Depth-sorted Gaussians a block of bin_count and bin_place takes (kChunk in
# csrc/binning.cu): the count table has one column per chunk.
BIN_CHUNK = 1024


def _check_gfeat(gfeat: torch.Tensor) -> None:
    kernels.check_cuda_tensor("gfeat", gfeat, torch.float32, 3)
    if gfeat.shape[-1] != GFEAT_WIDTH:
        raise ValueError(f"gfeat: expected {GFEAT_WIDTH} columns, got {gfeat.shape[-1]}")
    b, g, _ = gfeat.shape
    if b > 65535 or g >= 2**31:
        raise ValueError(f"gfeat: at most 65535 views of fewer than 2**31 Gaussians, got {b} x {g}")


def pack_rects(rects: torch.Tensor) -> torch.Tensor:
    """(..., 4) int32 rectangles -> (..., 2) int32, 16 bits a coordinate:
    (x0 | y0 << 16, x1 | y1 << 16); an empty one is (1, 0)."""
    r = rects.to(torch.int64)
    empty = (r[..., 2] < r[..., 0]) | (r[..., 3] < r[..., 1])
    packed = torch.stack([r[..., 0] | (r[..., 1] << 16), r[..., 2] | (r[..., 3] << 16)], dim=-1)
    packed = torch.where(empty[..., None], torch.tensor([1, 0], device=r.device), packed)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def unpack_rects(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of pack_rects: (..., 2) -> (..., 4) int32 (x0, y0, x1, y1)."""
    p = packed.to(torch.int64) & 0xFFFFFFFF
    rect = torch.stack([p[..., 0] & 0xFFFF, p[..., 0] >> 16, p[..., 1] & 0xFFFF, p[..., 1] >> 16], dim=-1)
    return rect.to(torch.int32)


def bin_count_plain(gfeat: torch.Tensor, ntx: int, nty: int, tile: int):
    """(B, G, 8) depth-sorted rows -> table (B, T, ceil(G / BIN_CHUNK)) int32,
    the Gaussians of each chunk that cover each tile; rects (B, G, 2) int32,
    each Gaussian's packed cull rectangle (pack_rects); aux (2,) int64 (zeros;
    bin_scan writes the number of pairs into aux[0])."""
    b, g, _ = gfeat.shape
    chunks, cells = -(-g // BIN_CHUNK), b * ntx * nty
    rects = bin_rects_plain(gfeat, ntx, nty, tile)[0]
    keys, vals = _pairs_of_rects(rects, ntx, nty)
    table = torch.bincount(keys * chunks + vals // BIN_CHUNK, minlength=cells * chunks)
    aux = torch.zeros(2, dtype=torch.int64, device=gfeat.device)
    return table.to(torch.int32).reshape(b, ntx * nty, chunks), pack_rects(rects), aux


def _check_grid(ntx: int, nty: int) -> None:
    if ntx > 65535 or nty > 65535 or ntx * nty >= 2**31:
        raise ValueError(f"a tile grid of {ntx} x {nty}: at most 65535 tiles a side and 2**31 in all")


def bin_count(gfeat: torch.Tensor, ntx: int, nty: int, tile: int):
    if not gfeat.is_cuda:
        return bin_count_plain(gfeat, ntx, nty, tile)
    _check_gfeat(gfeat)
    _check_grid(ntx, nty)
    b, g, _ = gfeat.shape
    table = torch.empty((b, ntx * nty, -(-g // BIN_CHUNK)), dtype=torch.int32, device=gfeat.device)
    rects = torch.empty((b, g, 2), dtype=torch.int32, device=gfeat.device)
    aux = torch.empty(2, dtype=torch.int64, device=gfeat.device)
    if table.numel():
        kernels.call(
            "tp_bin_count", "bin_count",
            gfeat.data_ptr(), table.data_ptr(), rects.data_ptr(), aux.data_ptr(), b, g, ntx, nty, tile, BIN_CHUNK,
        )
    else:
        rects[...] = torch.tensor([1, 0], dtype=torch.int32, device=gfeat.device)
        aux.zero_()
    return table, rects, aux


def bin_scan_plain(table: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    """table (B, T, chunks) counts, in place -> each (view, tile) row's
    exclusive prefix over the chunks (JAX's `chunk_bases` without its last
    column); returns ranges (B * T, 2) int32, [start, end) of each cell in
    the list ((0, 0) where empty), and writes the number of pairs to aux[0]."""
    rows = table.reshape(table.shape[0] * table.shape[1], table.shape[2]).to(torch.int64)
    incl = torch.cumsum(rows, dim=1)
    totals = incl[:, -1] if rows.shape[1] else torch.zeros(rows.shape[0], dtype=torch.int64, device=table.device)
    table.copy_((incl - rows).reshape(table.shape))
    start = torch.cumsum(totals, 0) - totals
    ranges = torch.where((totals > 0)[:, None], torch.stack([start, start + totals], dim=-1), 0)
    aux[0] = totals.sum()
    return ranges.to(torch.int32)


def bin_scan(table: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    if not table.is_cuda:
        return bin_scan_plain(table, aux)
    kernels.check_cuda_tensor("table", table, torch.int32, 3)
    kernels.check_cuda_tensor("aux", aux, torch.int64, 1)
    b, t, chunks = table.shape
    rowtot = torch.empty(b * t, dtype=torch.int32, device=table.device)
    ranges = torch.empty((b * t, 2), dtype=torch.int32, device=table.device)
    if table.numel():
        kernels.call(
            "tp_bin_scan", "bin_scan",
            table.data_ptr(), rowtot.data_ptr(), ranges.data_ptr(), aux.data_ptr(), b * t, chunks,
        )
    else:
        ranges.zero_()
    return ranges


def bin_place_plain(rects, bases, ranges, total: int, ntx: int, nty: int) -> torch.Tensor:
    """Every pair of the packed rectangles (bin_count) at its cell's start +
    its chunk's prefix (bases, from bin_scan) + the number of earlier
    Gaussians of its chunk on the same tile -> idx (total,) int32, the
    depth-sorted rank of each pair."""
    keys, vals = _pairs_of_rects(unpack_rects(rects), ntx, nty)
    chunks = bases.shape[-1]
    column = keys * chunks + vals // BIN_CHUNK  # the pair's (cell, chunk)
    # Pairs of one (cell, chunk) come in depth order; count the earlier ones.
    order = torch.sort(column, stable=True)[1]
    first = torch.searchsorted(column[order], column[order], right=False)
    earlier = torch.empty_like(column)
    earlier[order] = torch.arange(column.shape[0], device=column.device) - first
    pos = ranges[keys, 0].to(torch.int64) + bases.reshape(-1)[column].to(torch.int64) + earlier
    idx = torch.empty(total, dtype=torch.int32, device=rects.device)
    idx[pos] = vals.to(torch.int32)
    return idx


def bin_place(rects, bases, ranges, total: int, ntx: int, nty: int) -> torch.Tensor:
    if not rects.is_cuda:
        return bin_place_plain(rects, bases, ranges, total, ntx, nty)
    kernels.check_cuda_tensor("rects", rects, torch.int32, 3)
    kernels.check_cuda_tensor("bases", bases, torch.int32, 3)
    kernels.check_cuda_tensor("ranges", ranges, torch.int32, 2)
    b, g, _ = rects.shape
    if rects.shape[-1] != 2 or bases.shape != (b, ntx * nty, -(-g // BIN_CHUNK)) or ranges.shape != (b * ntx * nty, 2):
        raise ValueError("bin_place: rects, bases and ranges disagree in shape")
    _check_grid(ntx, nty)
    idx = torch.empty(total, dtype=torch.int32, device=rects.device)
    if total:
        kernels.call(
            "tp_bin_place", "bin_place",
            rects.data_ptr(), bases.data_ptr(), ranges.data_ptr(), idx.data_ptr(), b, g, ntx, nty, BIN_CHUNK,
        )
    return idx


def bin_gaussians(gfeat: torch.Tensor, image_shape: tuple[int, int], tile: int = 16) -> TileLists:
    """Depth-sorted (B, G, 8) rows -> per-tile index lists (no capacity,
    nothing dropped), equal to bin_gaussians_plain's: count, scan, then one
    host read of the number of pairs (idx is allocated to it), then place.
    The lists keep the count's packed rectangles for K2's deterministic order."""
    ntx, nty = grid_size(image_shape, tile)
    table, rects, aux = bin_count(gfeat, ntx, nty, tile)
    ranges = bin_scan(table, aux)
    total = int(aux[0])
    if total >= 2**31:
        raise ValueError(f"bin_gaussians: {total} pairs do not fit the int32 ranges")
    idx = bin_place(rects, table, ranges, total, ntx, nty)
    return TileLists(idx=idx, ranges=ranges, num_tiles_x=ntx, num_tiles_y=nty, rects=rects)


# ---------------------------------------------------------------------------
# Backward (K2): list-entry gradients summed back into Gaussian rows
# ---------------------------------------------------------------------------


def _pairs_per_view(lists: TileLists, views: int) -> torch.Tensor:
    """(B,) int64 number of list entries of each view (entries are sorted by view, then tile)."""
    lengths = (lists.ranges[:, 1] - lists.ranges[:, 0]).to(torch.int64)
    return lengths.reshape(views, -1).sum(dim=1)


def _pair_rows(lists: TileLists, views: int, g: int) -> torch.Tensor:
    """(N,) int64 row view * G + idx of every list entry in the flattened (B * G) Gaussians."""
    n = lists.idx.shape[0]
    view = torch.repeat_interleave(
        torch.arange(views, device=lists.idx.device), _pairs_per_view(lists, views), output_size=n
    )
    return view * g + lists.idx.to(torch.int64)


def pair_width(channels: int) -> int:
    """Width of a gradient row of d_pair (one per list entry) and d_feat (one
    per Gaussian): the 8 geometry columns, then the C colour columns
    zero-padded to a multiple of 4, so that a row is whole 16-byte vectors
    (K2 reads and adds it as such)."""
    return GFEAT_WIDTH + 4 * ((channels + 3) // 4)


def split_rows(d_feat: torch.Tensor, views: int, g: int, channels: int):
    """(B * G, pair_width(C)) gradient rows -> d_gfeat (B, G, 8), d_colors (B, G, C)."""
    d_feat = d_feat.reshape(views, g, d_feat.shape[-1])
    return d_feat[..., :GFEAT_WIDTH], d_feat[..., GFEAT_WIDTH : GFEAT_WIDTH + channels]


def bin_bwd_plain(d_pair: torch.Tensor, lists: TileLists, views: int, g: int, channels: int):
    """d_pair (N, pair_width(C)) -> d_gfeat (B, G, 8), d_colors (B, G, C): index_add_ by Gaussian."""
    d_feat = torch.zeros((views * g, d_pair.shape[1]), dtype=d_pair.dtype, device=d_pair.device)
    d_feat.index_add_(0, _pair_rows(lists, views, g), d_pair)
    return split_rows(d_feat, views, g, channels)


# The deterministic mode's order: the list entries Gaussian by Gaussian, each
# Gaussian's in list order, as `perm` (N,) int32 and each (view, Gaussian)
# row's segment start `offsets` (B * G + 1,) int32 (CSR: row i's entries are
# perm[offsets[i]:offsets[i + 1]]). That is torch.sort(view * G + idx,
# stable=True), which K1's lists imply with no sort: a Gaussian's entries are
# the tiles of its rectangle, one each, in increasing tile order.

# (View, Gaussian) rows a block of the order's first kernel scans (kScanRows
# in csrc/binning_bwd.cu); its second kernel keeps one int per such block in
# shared memory (kMaxScanBlocks).
BWD_SCAN_ROWS = 2048
BWD_MAX_SCAN_BLOCKS = 48 * 1024


def bin_bwd_order_by_sort(lists: TileLists, views: int, g: int):
    """The order by a stable sort of the keys view * G + idx and the runs'
    starts: the reference the order's kernels and plain version are held to
    (tests only)."""
    rows_sorted, perm = torch.sort(_pair_rows(lists, views, g), stable=True)
    cells = torch.arange(views * g + 1, device=rows_sorted.device)
    return perm.to(torch.int32), torch.searchsorted(rows_sorted, cells).to(torch.int32)


def bin_bwd_order_plain(lists: TileLists, views: int, g: int):
    """Plain version of the order's kernels, arithmetic and with no sort: the
    segments are the exclusive prefix of the rectangles' areas, and an entry
    of tile (tx, ty) goes to its Gaussian's start + (ty - y0) (x1 - x0 + 1) + (tx - x0)."""
    r = unpack_rects(lists.rects).reshape(views * g, 4).to(torch.int64)
    x0, y0, x1, y1 = r.unbind(-1)
    wide = x1 - x0 + 1
    area = torch.where((x1 >= x0) & (y1 >= y0), wide * (y1 - y0 + 1), 0)
    offsets = torch.cat([area.new_zeros(1), torch.cumsum(area, 0)])
    n, tiles, ntx = lists.idx.shape[0], lists.num_tiles_x * lists.num_tiles_y, lists.num_tiles_x
    lengths = (lists.ranges[:, 1] - lists.ranges[:, 0]).to(torch.int64)
    cell = torch.repeat_interleave(torch.arange(lengths.shape[0], device=lengths.device), lengths, output_size=n)
    t = cell % tiles
    row = (cell // tiles) * g + lists.idx.to(torch.int64)
    place = offsets[row] + (t // ntx - y0[row]) * wide[row] + (t % ntx - x0[row])
    perm = torch.empty(n, dtype=torch.int32, device=lists.idx.device)
    perm[place] = torch.arange(n, dtype=torch.int32, device=perm.device)
    return perm, offsets.to(torch.int32)


def bin_bwd_order(lists: TileLists, views: int, g: int):
    """K2's deterministic order (perm, offsets), read off K1's packed
    rectangles (`lists.rects`, which bin_gaussians keeps): csrc/binning_bwd.cu
    `tp_bin_bwd_order` for CUDA lists, bin_bwd_order_plain for CPU lists."""
    if lists.rects is None:
        raise ValueError("bin_bwd_order: the lists carry no rectangles (bin_gaussians keeps K1's with its lists)")
    if not lists.idx.is_cuda:
        return bin_bwd_order_plain(lists, views, g)
    kernels.check_cuda_tensor("idx", lists.idx, torch.int32, 1)
    kernels.check_cuda_tensor("ranges", lists.ranges, torch.int32, 2)
    kernels.check_cuda_tensor("rects", lists.rects, torch.int32, 3)
    ntx, nty = lists.num_tiles_x, lists.num_tiles_y
    rows, n = views * g, lists.idx.shape[0]
    if lists.rects.shape != (views, g, 2) or lists.ranges.shape != (views * ntx * nty, 2):
        raise ValueError("bin_bwd_order: rects or ranges disagree with the views and Gaussians")
    blocks = -(-rows // BWD_SCAN_ROWS)
    if rows >= 2**31 or n >= 2**31 or blocks > BWD_MAX_SCAN_BLOCKS:
        raise ValueError(f"bin_bwd_order: {rows} Gaussians or {n} pairs are too many for its kernels")
    _check_grid(ntx, nty)
    dev = lists.idx.device
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    offsets = torch.empty(rows + 1, dtype=torch.int32, device=dev)
    if rows:
        scratch = torch.empty(4 * rows + blocks + lists.ranges.shape[0], dtype=torch.int32, device=dev)
        kernels.call(
            "tp_bin_bwd_order", "bin_bwd_order",
            lists.idx.data_ptr(), lists.ranges.data_ptr(), lists.rects.data_ptr(), scratch.data_ptr(),
            perm.data_ptr(), offsets.data_ptr(), n, views, g, ntx, nty,
        )
    else:
        offsets.zero_()
    return perm, offsets


def bin_bwd_sorted_plain(d_pair: torch.Tensor, perm: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of the segment sums: d_feat (rows, width), row i the sum
    of d_pair[perm[offsets[i]:offsets[i + 1]]] taken in that order, from 0."""
    starts, lengths = offsets[:-1].to(torch.int64), (offsets[1:] - offsets[:-1]).to(torch.int64)
    d_feat = torch.zeros((starts.shape[0], d_pair.shape[1]), dtype=d_pair.dtype, device=d_pair.device)
    for depth in range(int(lengths.max()) if lengths.numel() else 0):
        rows = torch.nonzero(lengths > depth).squeeze(1)
        d_feat[rows] = d_feat[rows] + d_pair[perm[starts[rows] + depth].to(torch.int64)]
    return d_feat


def bin_bwd_sorted(d_pair: torch.Tensor, perm: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The deterministic mode's segment sums (csrc/binning_bwd.cu
    `tp_bin_bwd_sorted`) for CUDA tensors, bin_bwd_sorted_plain for CPU ones."""
    if not d_pair.is_cuda:
        return bin_bwd_sorted_plain(d_pair, perm, offsets)
    kernels.check_cuda_tensor("d_pair", d_pair, torch.float32, 2)
    kernels.check_cuda_tensor("perm", perm, torch.int32, 1)
    kernels.check_cuda_tensor("offsets", offsets, torch.int32, 1)
    n, row = d_pair.shape
    if perm.shape[0] != n or row not in (12, 16) or d_pair.data_ptr() % 16:
        raise ValueError(f"bin_bwd_sorted: d_pair {tuple(d_pair.shape)} (16-byte rows of 12 or 16) disagrees with perm")
    d_feat = torch.empty((offsets.shape[0] - 1, row), dtype=torch.float32, device=d_pair.device)
    if d_feat.shape[0]:
        kernels.call(
            "tp_bin_bwd_sorted", "bin_bwd_sorted",
            d_pair.data_ptr(), perm.data_ptr(), offsets.data_ptr(), d_feat.data_ptr(), d_feat.shape[0], n, row,
        )
    return d_feat


def bin_bwd(d_pair: torch.Tensor, lists: TileLists, views: int, g: int, channels: int, deterministic: bool = False):
    """K2: the transpose of the binning's routing. d_pair (N, pair_width(C)),
    one row per list entry -> d_gfeat (B, G, 8), d_colors (B, G, C).

    On the card the default adds with 16-byte float atomics (the last bits
    change from run to run); `deterministic` adds each Gaussian's entries in
    list order (bin_bwd_order, then bin_bwd_sorted), which needs the lists'
    rectangles."""
    if not d_pair.is_cuda:
        return bin_bwd_plain(d_pair, lists, views, g, channels)
    kernels.check_cuda_tensor("d_pair", d_pair, torch.float32, 2)
    kernels.check_cuda_tensor("idx", lists.idx, torch.int32, 1)
    kernels.check_cuda_tensor("ranges", lists.ranges, torch.int32, 2)
    n, row = d_pair.shape
    cells = views * lists.num_tiles_x * lists.num_tiles_y
    if lists.idx.shape[0] != n or row != pair_width(channels) or lists.ranges.shape != (cells, 2):
        raise ValueError(f"bin_bwd: d_pair {tuple(d_pair.shape)} disagrees with the lists or {channels} channels")
    if views * g >= 2**31 or views > 1024:
        raise ValueError("bin_bwd: views * Gaussians must fit in int32, and views be at most 1024")
    if deterministic:
        d_feat = bin_bwd_sorted(d_pair, *bin_bwd_order(lists, views, g))
    else:
        d_feat = torch.zeros((views * g, row), dtype=torch.float32, device=d_pair.device)
        if n:
            # Entries are sorted by view, then tile: a view's entries end at
            # the largest end among its tiles (the kernel takes a running max
            # over the views, for views without entries).
            view_max = lists.ranges[:, 1].reshape(views, -1).amax(dim=1)
            kernels.call(
                "tp_bin_bwd", "bin_bwd",
                d_pair.data_ptr(), lists.idx.data_ptr(), view_max.data_ptr(), d_feat.data_ptr(), n, row, views, g,
            )
    return split_rows(d_feat, views, g, channels)
