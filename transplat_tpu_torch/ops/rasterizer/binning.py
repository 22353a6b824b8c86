"""Tile binning (K1): depth-ordered per-tile Gaussian lists.

Counterpart of transplat_tpu/ops/rasterizer/pallas_binning.py
(`build_sorted_features`, `cull_radii`, `_bin_fwd_kernel`). The port builds
index lists plus per-tile [start, end) ranges instead of routed feature
copies, with no capacity and nothing dropped (csrc/binning.cu says how).

Each step has a wrapper that launches its CUDA kernel for CUDA tensors and
runs its plain PyTorch version (same arithmetic, `*_plain`) for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ... import kernels
from .projection import ProjectedGaussians

# gfeat columns (float32, 8 per Gaussian so a row is two 16-byte loads).
MEAN_X, MEAN_Y, CONIC_A, CONIC_B, CONIC_C, RADIUS, OPACITY = range(7)
GFEAT_WIDTH = 8


class TileLists(NamedTuple):
    idx: torch.Tensor  # (N,) int32 depth-sorted Gaussian index of each pair, tile-major
    ranges: torch.Tensor  # (B * T, 2) int32 [start, end) of each (view, tile) in idx
    num_tiles_x: int
    num_tiles_y: int


def sort_by_depth(proj: ProjectedGaussians, feature: torch.Tensor | None = None):
    """Projected Gaussians -> depth-sorted (B, G, 8) geometry rows and (B, G, C) colours.

    Live Gaussians (valid, radius > 0) first, by depth, stably (ties keep
    their original order, as JAX's stable sort does); dead ones last with
    radius and opacity 0 and their means at 1e9."""
    live = proj.valid & (proj.radius > 0.0)
    depth_key = torch.where(live, proj.depth, torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(depth_key, dim=-1, stable=True)
    big = torch.full_like(proj.depth, 1e9)
    zero = torch.zeros_like(proj.depth)
    cols = torch.stack(
        [
            torch.where(live, proj.mean2d[..., 0], big),
            torch.where(live, proj.mean2d[..., 1], big),
            proj.conic[..., 0],
            proj.conic[..., 1],
            proj.conic[..., 2],
            torch.where(live, proj.radius, zero),
            torch.where(live, proj.opacity, zero),
            zero,
        ],
        dim=-1,
    )
    color = proj.rgb if feature is None else feature
    if color.shape[-1] > 8:
        raise ValueError(f"at most 8 colour channels, got {color.shape[-1]}")
    gfeat = torch.take_along_dim(cols, order[..., None], dim=1).contiguous()
    colors = torch.take_along_dim(color, order[..., None], dim=1).contiguous()
    return gfeat, colors


def grid_size(image_shape: tuple[int, int], tile: int) -> tuple[int, int]:
    h, w = image_shape
    return (w + tile - 1) // tile, (h + tile - 1) // tile


# ---------------------------------------------------------------------------
# Step 2: tile rectangles under the exact significance cull
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


def bin_rects(gfeat: torch.Tensor, ntx: int, nty: int, tile: int):
    if not gfeat.is_cuda:
        return bin_rects_plain(gfeat, ntx, nty, tile)
    kernels.check_cuda_tensor("gfeat", gfeat, torch.float32, 3)
    if gfeat.shape[-1] != GFEAT_WIDTH:
        raise ValueError(f"gfeat: expected {GFEAT_WIDTH} columns, got {gfeat.shape[-1]}")
    b, g, _ = gfeat.shape
    rects = torch.empty((b, g, 4), dtype=torch.int32, device=gfeat.device)
    counts = torch.empty((b, g), dtype=torch.int32, device=gfeat.device)
    kernels.call(
        "tp_bin_rects", "bin_rects",
        gfeat.data_ptr(), rects.data_ptr(), counts.data_ptr(), b * g, ntx, nty, tile,
    )
    return rects, counts


# ---------------------------------------------------------------------------
# Step 3: one (view * T + tile, Gaussian) pair per covered tile
# ---------------------------------------------------------------------------


def bin_emit_plain(rects, counts, incl, total: int, num_tiles: int, ntx: int):
    """rects (B, G, 4), counts (B, G), incl (B*G,) int64 inclusive cumsum of
    counts -> keys (N,) int32 and vals (N,) int32 (sorted-Gaussian ranks)."""
    g = counts.shape[1]
    n = counts.reshape(-1).to(torch.int64)
    r = rects.reshape(-1, 4).to(torch.int64)
    gid = torch.repeat_interleave(torch.arange(n.shape[0], device=n.device), n, output_size=total)
    j = torch.arange(total, device=n.device) - (incl - n)[gid]
    width = (r[:, 2] - r[:, 0] + 1)[gid]
    tx = r[gid, 0] + j % width
    ty = r[gid, 1] + j // width
    keys = (gid // g) * num_tiles + ty * ntx + tx
    return keys.to(torch.int32), (gid % g).to(torch.int32)


def bin_emit(rects, counts, incl, total: int, num_tiles: int, ntx: int):
    if not rects.is_cuda:
        return bin_emit_plain(rects, counts, incl, total, num_tiles, ntx)
    kernels.check_cuda_tensor("rects", rects, torch.int32, 3)
    kernels.check_cuda_tensor("counts", counts, torch.int32, 2)
    kernels.check_cuda_tensor("incl", incl, torch.int64, 1)
    b, g = counts.shape
    if rects.shape != (b, g, 4) or incl.shape[0] != b * g:
        raise ValueError("bin_emit: rects, counts and incl disagree in shape")
    keys = torch.empty((total,), dtype=torch.int32, device=rects.device)
    vals = torch.empty((total,), dtype=torch.int32, device=rects.device)
    if total:
        kernels.call(
            "tp_bin_emit", "bin_emit",
            rects.data_ptr(), counts.data_ptr(), incl.data_ptr(), keys.data_ptr(),
            vals.data_ptr(), b * g, g, num_tiles, ntx,
        )
    return keys, vals


# ---------------------------------------------------------------------------
# Step 5: per-tile [start, end) in the tile-sorted pair list
# ---------------------------------------------------------------------------


def bin_ranges_plain(keys_sorted: torch.Tensor, num_cells: int) -> torch.Tensor:
    """(num_cells, 2) int32 [start, end) of each cell's run; (0, 0) for an empty cell."""
    cells = torch.arange(num_cells, dtype=keys_sorted.dtype, device=keys_sorted.device)
    start = torch.searchsorted(keys_sorted, cells, right=False)
    end = torch.searchsorted(keys_sorted, cells, right=True)
    ranges = torch.stack([start, end], dim=-1)
    return torch.where((end > start)[:, None], ranges, 0).to(torch.int32)


def bin_ranges(keys_sorted: torch.Tensor, num_cells: int) -> torch.Tensor:
    if not keys_sorted.is_cuda:
        return bin_ranges_plain(keys_sorted, num_cells)
    kernels.check_cuda_tensor("keys_sorted", keys_sorted, torch.int32, 1)
    ranges = torch.zeros((num_cells, 2), dtype=torch.int32, device=keys_sorted.device)
    if keys_sorted.shape[0]:
        kernels.call("tp_bin_ranges", "bin_ranges", keys_sorted.data_ptr(), ranges.data_ptr(), keys_sorted.shape[0])
    return ranges


# ---------------------------------------------------------------------------
# The whole binning
# ---------------------------------------------------------------------------


def bin_gaussians(gfeat: torch.Tensor, image_shape: tuple[int, int], tile: int = 16) -> TileLists:
    """Depth-sorted (B, G, 8) rows -> per-tile index lists (no capacity, nothing dropped)."""
    ntx, nty = grid_size(image_shape, tile)
    b, g, _ = gfeat.shape
    num_tiles = ntx * nty
    rects, counts = bin_rects(gfeat, ntx, nty, tile)
    incl = torch.cumsum(counts.reshape(-1), dim=0, dtype=torch.int64)
    total = int(incl[-1]) if incl.numel() else 0
    keys, vals = bin_emit(rects, counts, incl, total, num_tiles, ntx)
    keys_sorted, perm = torch.sort(keys, stable=True)
    idx = vals[perm].contiguous()
    ranges = bin_ranges(keys_sorted, b * num_tiles)
    return TileLists(idx=idx, ranges=ranges, num_tiles_x=ntx, num_tiles_y=nty)
