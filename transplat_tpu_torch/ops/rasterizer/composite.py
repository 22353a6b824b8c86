"""Tile compositing (K3) and its backward (K4): front-to-back alpha blending
of per-tile lists.

Counterpart of transplat_tpu/ops/rasterizer/pallas_composite.py
(`_composite_fwd_kernel`, `_composite_bwd_kernel`, the `composite_pallas`
custom_vjp) plus the background / raster-order epilogue of its api.py caller.
`composite_tiles` is an autograd.Function: for CUDA tensors it launches the
kernels (csrc/composite.cu, csrc/composite_bwd.cu, then K2 of binning.py);
for CPU tensors it runs `composite_tiles_plain` and
`composite_tiles_bwd_plain`.

A warp of either kernel skips the entries whose conservative pixel
rectangle (`entry_rects`) misses its 8x4 pixels (`warp_masks`): the plain
versions of what the kernels compute for that (csrc/composite.cuh). Where a
backward follows, both take their tiles longest list first (`tile_order`):
the sort pays for itself in K4 and K3 shares it; a forward alone takes its
tiles in cell order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ... import kernels
from .binning import CONIC_A, CONIC_B, CONIC_C, GFEAT_WIDTH, MEAN_X, MEAN_Y, OPACITY, RADIUS, TileLists, bin_bwd, pair_width
from .projection import ALPHA_MAX, ALPHA_MIN, gaussian_alpha
from .reference import TRANSMITTANCE_EPS


# A warp of the kernels covers FOOTPRINT = (width, height) pixels of its tile;
# warp w sits at column w % (16 // width), row w // (16 // width).
FOOTPRINT = (8, 4)
# Past this |mean| or radius the kernels cull nothing (csrc/composite.cuh).
CULL_LIMIT = 1e6


def tile_order(lists: TileLists) -> torch.Tensor:
    """(cells,) int32: the (view, tile) cells by list length, longest first,
    ties in cell order: the order in which the kernels take their tiles."""
    lengths = lists.ranges[:, 1] - lists.ranges[:, 0]
    return torch.sort(lengths, descending=True, stable=True).indices.to(torch.int32)


def entry_rects(rows: torch.Tensor, origin_x: torch.Tensor, origin_y: torch.Tensor, tile: int = 16) -> torch.Tensor:
    """(..., 4) float (x0, y0, x1, y1): the conservative pixel rectangle of each
    geometry row (..., 8) in its tile at (origin_x, origin_y), tile-local and
    inclusive: floor(mean - radius) - 1 .. ceil(mean + radius) + 1, clipped to
    the tile (empty where x0 > x1 or y0 > y1). A pixel outside it fails the
    radius test in float32; past CULL_LIMIT, or for NaN, it is the whole tile."""
    mx, my, r = rows[..., MEAN_X], rows[..., MEAN_Y], rows[..., RADIUS].abs()
    ok = (r < CULL_LIMIT) & (mx.abs() < CULL_LIMIT) & (my.abs() < CULL_LIMIT)
    last = float(tile - 1)
    x0 = torch.clamp(torch.floor(mx - r) - 1.0 - origin_x, min=0.0)
    x1 = torch.clamp(torch.ceil(mx + r) + 1.0 - origin_x, max=last)
    y0 = torch.clamp(torch.floor(my - r) - 1.0 - origin_y, min=0.0)
    y1 = torch.clamp(torch.ceil(my + r) + 1.0 - origin_y, max=last)
    rect = torch.stack([x0, y0, x1, y1], dim=-1)
    whole = torch.tensor([0.0, 0.0, last, last], dtype=rows.dtype, device=rows.device)
    return torch.where(ok[..., None], rect, whole)


def warp_masks(rects: torch.Tensor, footprint: tuple[int, int] = FOOTPRINT, tile: int = 16) -> torch.Tensor:
    """(...,) int64 bit set of the warps whose footprint meets each rectangle (entry_rects)."""
    fw, fh = footprint
    mask = torch.zeros(rects.shape[:-1], dtype=torch.int64, device=rects.device)
    for w in range(tile * tile // 32):
        fx, fy = (w % (tile // fw)) * fw, (w // (tile // fw)) * fh
        meets = (rects[..., 0] <= fx + fw - 1) & (rects[..., 2] >= fx) & (rects[..., 1] <= fy + fh - 1) & (rects[..., 3] >= fy)
        mask |= meets.to(torch.int64) << w
    return mask


def _tiles_to_image(x: torch.Tensor, b: int, ntx: int, nty: int, tile: int, image_shape) -> torch.Tensor:
    """(B*T, tile*tile, C) in tile-major order -> (B, h, w, C) raster order."""
    c = x.shape[-1]
    x = x.reshape(b, nty, ntx, tile, tile, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, nty * tile, ntx * tile, c)
    return x[:, : image_shape[0], : image_shape[1]]


def _image_to_tiles(x: torch.Tensor, ntx: int, nty: int, tile: int) -> torch.Tensor:
    """(B, h, w, C) raster order -> (B*T, tile*tile, C) tile-major, zero-padded to whole tiles."""
    b, h, w, c = x.shape
    x = torch.nn.functional.pad(x, (0, 0, 0, ntx * tile - w, 0, nty * tile - h))
    x = x.reshape(b, nty, tile, ntx, tile, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nty * ntx, tile * tile, c)


class _Chunk(NamedTuple):
    """One chunk of every cell's padded list, as both plain compositors see it."""

    mask: torch.Tensor  # (cells, K) entry exists
    pos: torch.Tensor  # (cells, K) its row in the pair list (clamped where it does not)
    f: torch.Tensor  # (cells, K, 8) geometry rows
    col: torch.Tensor  # (cells, K, C) colours


def _cells(gfeat, lists: TileLists, tile: int):
    """Per-cell view, list start and length, and pixel centres (cells, P, 1, 2)."""
    b = gfeat.shape[0]
    ntx, t_count = lists.num_tiles_x, lists.num_tiles_x * lists.num_tiles_y
    dev = gfeat.device
    cells = b * t_count
    view = torch.arange(cells, device=dev) // t_count
    tile_id = torch.arange(cells, device=dev) % t_count
    lane = torch.arange(tile * tile, device=dev)
    px = ((tile_id % ntx) * tile)[:, None] + (lane % tile)[None]
    py = ((tile_id // ntx) * tile)[:, None] + (lane // tile)[None]
    pix = torch.stack([px, py], dim=-1).to(gfeat.dtype)[:, :, None, :]
    start = lists.ranges[:, 0].long()
    length = (lists.ranges[:, 1] - lists.ranges[:, 0]).long()
    return view, start, length, pix


def _chunks(gfeat, colors, lists: TileLists, view, start, length, chunk: int):
    max_len = int(length.max()) if length.numel() else 0
    n_idx = lists.idx.shape[0]
    for k0 in range(0, max_len, chunk):
        kk = k0 + torch.arange(chunk, device=gfeat.device)
        mask = kk[None, :] < length[:, None]
        pos = torch.clamp(start[:, None] + kk[None, :], max=max(n_idx - 1, 0))
        gi = torch.where(mask, lists.idx[pos].long(), 0)
        yield _Chunk(mask, pos, gfeat[view[:, None], gi], colors[view[:, None], gi])


def _transmittance(t_run, alpha):
    """T before each entry of a chunk (exclusive cumprod from t_run) and the live gate."""
    cum = torch.cumprod(1.0 - alpha, dim=-1)
    t_before = t_run[..., None] * torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]], dim=-1)
    return t_before, t_before >= TRANSMITTANCE_EPS


def composite_tiles_plain(
    gfeat: torch.Tensor,  # (B, G, 8) depth-sorted geometry rows
    colors: torch.Tensor,  # (B, G, C)
    lists: TileLists,
    background: torch.Tensor,  # (B, C)
    image_shape: tuple[int, int],
    tile: int = 16,
    chunk: int = 64,
):
    """Plain tiled compositor, vectorised over tiles x pixels x a chunk of
    each padded list; the transmittance is an exclusive cumprod.

    Returns ((B, h, w, C) image, (B, h, w) final transmittance, evaluations):
    evaluations counts the (pixel, list entry) pairs a compositor must visit
    before every tile saturates, i.e. the work the kernel needs on these
    inputs."""
    b = gfeat.shape[0]
    c = colors.shape[-1]
    ntx, nty = lists.num_tiles_x, lists.num_tiles_y
    p = tile * tile
    view, start, length, pix = _cells(gfeat, lists, tile)
    cells = view.shape[0]
    t_run = torch.ones((cells, p), dtype=gfeat.dtype, device=gfeat.device)
    acc = torch.zeros((cells, p, c), dtype=gfeat.dtype, device=gfeat.device)
    evaluations = 0
    for ch in _chunks(gfeat, colors, lists, view, start, length, chunk):
        opacity = torch.where(ch.mask, ch.f[..., OPACITY], torch.zeros_like(ch.f[..., OPACITY]))
        alpha = gaussian_alpha(
            ch.f[:, None, :, CONIC_A : CONIC_C + 1],
            ch.f[:, None, :, MEAN_X : MEAN_Y + 1],
            opacity[:, None, :],
            pix,
            ch.f[:, None, :, RADIUS],
        )  # (cells, P, K)
        t_before, live = _transmittance(t_run, alpha)
        contrib = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
        acc = acc + torch.matmul(contrib, ch.col)
        t_run = t_run * torch.prod(torch.where(live, 1.0 - alpha, torch.ones_like(alpha)), dim=-1)
        evaluations += int((live.any(dim=1) & ch.mask).sum()) * p
    out = acc + t_run[..., None] * background[view][:, None, :]
    image = _tiles_to_image(out, b, ntx, nty, tile, image_shape)
    t_final = _tiles_to_image(t_run[..., None], b, ntx, nty, tile, image_shape)[..., 0]
    return image, t_final, evaluations


def composite_tiles_bwd_plain(
    gfeat: torch.Tensor,  # (B, G, 8)
    colors: torch.Tensor,  # (B, G, C)
    lists: TileLists,
    background: torch.Tensor,  # (B, C)
    image: torch.Tensor,  # (B, h, w, C) the forward's output
    t_final: torch.Tensor,  # (B, h, w) the forward's final transmittance
    g_out: torch.Tensor,  # (B, h, w, C) cotangent of the image
    tile: int = 16,
    chunk: int = 64,
) -> torch.Tensor:
    """Plain PyTorch version of K4: d_pair (N, pair_width(C)), the gradient of
    every tile-list entry (mean x, y, conic a, b, c, radius = 0, opacity,
    pad = 0, colours, zeros to a multiple of 4) summed over its tile's pixels,
    term by term as
    csrc/composite_bwd.cu computes it; the transmittance is the forward plain
    version's exclusive cumprod, so both take the same live gate."""
    c = colors.shape[-1]
    ntx, nty = lists.num_tiles_x, lists.num_tiles_y
    view, start, length, pix = _cells(gfeat, lists, tile)
    cells = view.shape[0]
    dt, dev = gfeat.dtype, gfeat.device
    g = _image_to_tiles(g_out, ntx, nty, tile)  # (cells, P, C)
    out = _image_to_tiles(image, ntx, nty, tile)
    tfin = _image_to_tiles(t_final[..., None], ntx, nty, tile)[..., 0]  # (cells, P)
    bg = background[view][:, None, :]
    g_t_tfin = torch.sum(g * bg, dim=-1) * tfin
    g_total = torch.sum(g * (out - tfin[..., None] * bg), dim=-1)
    t_run = torch.ones((cells, tile * tile), dtype=dt, device=dev)
    prefix = torch.zeros_like(t_run)
    d_pair = torch.zeros((lists.idx.shape[0], pair_width(c)), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for ch in _chunks(gfeat, colors, lists, view, start, length, chunk):
        f = ch.f[:, None]  # (cells, 1, K, 8)
        a, b_, c_ = f[..., CONIC_A], f[..., CONIC_B], f[..., CONIC_C]
        dx = pix[..., 0] - f[..., MEAN_X]
        dy = pix[..., 1] - f[..., MEAN_Y]
        power = -0.5 * (a * dx * dx + c_ * dy * dy) - b_ * dx * dy
        e = torch.exp(power)
        raw = torch.where(ch.mask, ch.f[..., OPACITY], zero)[:, None] * e
        alpha = torch.clamp(raw, max=ALPHA_MAX)
        keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & (dx * dx + dy * dy <= f[..., RADIUS] ** 2)
        alpha = torch.where(keep, alpha, zero)
        t_before, live = _transmittance(t_run, alpha)
        weight = torch.where(live, alpha * t_before, zero)  # (cells, P, K)
        g_dot_c = torch.matmul(g, ch.col.transpose(-1, -2))
        contrib = g_dot_c * weight
        prefix_k = prefix[..., None] + torch.cumsum(contrib, dim=-1)
        one_minus = torch.clamp(1.0 - alpha, min=1.0 - ALPHA_MAX)
        d_alpha = g_dot_c * t_before - (g_total[..., None] - prefix_k) / one_minus - g_t_tfin[..., None] / one_minus
        d_alpha = torch.where(live & keep & (raw < ALPHA_MAX), d_alpha, zero)
        d_power = d_alpha * alpha
        per_pixel = [
            d_power * (a * dx + b_ * dy), d_power * (c_ * dy + b_ * dx),
            d_power * (-0.5 * dx * dx), d_power * (-dx * dy), d_power * (-0.5 * dy * dy),
            None, d_alpha * e, None,
        ]
        rows = torch.stack(
            [torch.zeros_like(ch.f[..., 0]) if x is None else x.sum(dim=1) for x in per_pixel], dim=-1
        )  # (cells, K, 8)
        d_col = torch.matmul(weight.transpose(-1, -2), g)  # (cells, K, C)
        d_pair[ch.pos[ch.mask], : rows.shape[-1] + c] = torch.cat([rows, d_col], dim=-1)[ch.mask]
        prefix = prefix + contrib.sum(dim=-1)
        t_run = t_run * torch.prod(torch.where(live, 1.0 - alpha, torch.ones_like(alpha)), dim=-1)
    return d_pair


class CompositeTiles(torch.autograd.Function):
    """composite_tiles with its hand-written backward. For CUDA tensors the
    forward is K3, the backward K4 (list-entry gradients) followed by K2
    (their sum per Gaussian); for CPU tensors their plain versions run."""

    @staticmethod
    def forward(ctx, gfeat, colors, background, lists, image_shape, tile, ordered):
        order = None
        if gfeat.is_cuda:
            order = tile_order(lists) if ordered else None
            image, t_final = _composite_fwd_cuda(gfeat, colors, lists, background, image_shape, tile, order=order)
        else:
            image, t_final, _ = composite_tiles_plain(gfeat, colors, lists, background, image_shape, tile)
        ctx.save_for_backward(gfeat, colors, background, lists.idx, lists.ranges, image, t_final, order)
        ctx.grid = (lists.num_tiles_x, lists.num_tiles_y)
        ctx.tile = tile
        return image

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        gfeat, colors, background, idx, ranges, image, t_final, order = ctx.saved_tensors
        lists = TileLists(idx, ranges, *ctx.grid)
        b, g, _ = gfeat.shape
        g_out = g_out.contiguous()
        if gfeat.is_cuda:
            d_pair = _composite_bwd_cuda(gfeat, colors, lists, background, image, t_final, g_out, order=order)
        else:
            d_pair = composite_tiles_bwd_plain(gfeat, colors, lists, background, image, t_final, g_out, ctx.tile)
        d_gfeat, d_colors = bin_bwd(d_pair, lists, b, g, colors.shape[-1])
        d_bg = None
        if ctx.needs_input_grad[2]:
            d_bg = torch.sum(g_out * t_final[..., None], dim=(1, 2))
        return d_gfeat, d_colors, d_bg, None, None, None, None


def _check_composite_args(gfeat, colors, lists: TileLists, background, tile: int):
    if tile != 16:
        raise ValueError(f"the CUDA compositor takes 16x16 tiles, got {tile}")
    kernels.check_cuda_tensor("gfeat", gfeat, torch.float32, 3)
    kernels.check_cuda_tensor("colors", colors, torch.float32, 3)
    kernels.check_cuda_tensor("idx", lists.idx, torch.int32, 1)
    kernels.check_cuda_tensor("ranges", lists.ranges, torch.int32, 2)
    kernels.check_cuda_tensor("background", background, torch.float32, 2)
    b, g, width = gfeat.shape
    c = colors.shape[-1]
    ntx, nty = lists.num_tiles_x, lists.num_tiles_y
    if width != GFEAT_WIDTH or colors.shape[:2] != (b, g) or not 1 <= c <= 8:
        raise ValueError(f"composite: bad shapes gfeat {tuple(gfeat.shape)} colors {tuple(colors.shape)}")
    if lists.ranges.shape != (b * ntx * nty, 2) or background.shape != (b, c):
        raise ValueError("composite: ranges or background disagree with the views")


def _block_times_arg(block_times, cells: int, device) -> int:
    """Pointer for a kernel's `block_times`: 0 (the main path) or a (cells, 2) int64 CUDA tensor."""
    if block_times is None:
        return 0
    kernels.check_cuda_tensor("block_times", block_times, torch.int64, 2)
    if block_times.shape != (cells, 2) or block_times.device != device:
        raise ValueError(f"block_times: expected ({cells}, 2) on {device}, got {tuple(block_times.shape)}")
    return block_times.data_ptr()


def _order_arg(order, lists: TileLists) -> int:
    """Pointer for the kernels' `order`: 0 (cells in their own order) or a (cells,) int32 CUDA tensor."""
    if order is None:
        return 0
    kernels.check_cuda_tensor("order", order, torch.int32, 1)
    if order.shape[0] != lists.ranges.shape[0]:
        raise ValueError(f"order: expected {lists.ranges.shape[0]} cells, got {order.shape[0]}")
    return order.data_ptr()


def _composite_fwd_cuda(gfeat, colors, lists: TileLists, background, image_shape, tile: int = 16, order=None,
                        block_times=None):
    """Launch K3: (image (B, h, w, C), final transmittance (B, h, w)).

    `order` is the tiles' launch order (tile_order(lists)); without it the
    blocks take the cells in their own order.
    `block_times`, a (cells, 2) int64 tensor, selects the measuring
    instantiation, which also writes each block's start and end (ns); it is
    counted as `composite_timed`, never as `composite`."""
    _check_composite_args(gfeat, colors, lists, background, tile)
    b, g, _ = gfeat.shape
    c = colors.shape[-1]
    h, w = image_shape
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=gfeat.device)
    t_final = torch.empty((b, h, w), dtype=torch.float32, device=gfeat.device)
    order = _order_arg(order, lists)
    timer = _block_times_arg(block_times, lists.ranges.shape[0], gfeat.device)
    kernels.call(
        "tp_composite", "composite_timed" if timer else "composite",
        gfeat.data_ptr(), colors.data_ptr(), lists.idx.data_ptr(), lists.ranges.data_ptr(), order,
        background.data_ptr(), out.data_ptr(), t_final.data_ptr(), b, g, c, h, w,
        lists.num_tiles_x, lists.num_tiles_y, timer,
    )
    return out, t_final


def _composite_bwd_cuda(gfeat, colors, lists: TileLists, background, image, t_final, g_out, tile: int = 16,
                        order=None, block_times=None):
    """Launch K4: d_pair (N, pair_width(C)), one gradient row per tile-list
    entry; the kernel writes every row (the lists' ranges cover the entries).

    `order` and `block_times` as for _composite_fwd_cuda (counted as
    `composite_bwd_timed`)."""
    _check_composite_args(gfeat, colors, lists, background, tile)
    b, g, _ = gfeat.shape
    c = colors.shape[-1]
    h, w = image.shape[1:3]
    kernels.check_cuda_tensor("image", image, torch.float32, 4)
    kernels.check_cuda_tensor("t_final", t_final, torch.float32, 3)
    kernels.check_cuda_tensor("g_out", g_out, torch.float32, 4)
    if image.shape != (b, h, w, c) or g_out.shape != image.shape or t_final.shape != (b, h, w):
        raise ValueError("composite_bwd: image, t_final and g_out disagree in shape")
    d_pair = torch.empty((lists.idx.shape[0], pair_width(c)), dtype=torch.float32, device=gfeat.device)
    order = _order_arg(order, lists)
    timer = _block_times_arg(block_times, lists.ranges.shape[0], gfeat.device)
    if d_pair.shape[0]:
        kernels.call(
            "tp_composite_bwd", "composite_bwd_timed" if timer else "composite_bwd",
            gfeat.data_ptr(), colors.data_ptr(), lists.idx.data_ptr(), lists.ranges.data_ptr(), order,
            background.data_ptr(), image.data_ptr(), t_final.data_ptr(), g_out.data_ptr(), d_pair.data_ptr(),
            b, g, c, h, w, lists.num_tiles_x, lists.num_tiles_y, timer,
        )
    return d_pair


def composite_tiles(
    gfeat: torch.Tensor,
    colors: torch.Tensor,
    lists: TileLists,
    background: torch.Tensor,
    image_shape: tuple[int, int],
    tile: int = 16,
) -> torch.Tensor:
    """(B, h, w, C) composite of the tile lists over `background` (B, C).

    Differentiable in gfeat, colors and background on both devices (the lists
    are constants)."""
    ordered = torch.is_grad_enabled() and any(t.requires_grad for t in (gfeat, colors, background))
    return CompositeTiles.apply(gfeat, colors, background, lists, tuple(image_shape), tile, ordered)
