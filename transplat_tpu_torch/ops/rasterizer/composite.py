"""Tile compositing (K3): front-to-back alpha blending of per-tile lists.

Counterpart of transplat_tpu/ops/rasterizer/pallas_composite.py
`_composite_fwd_kernel` plus the background / raster-order epilogue of its
api.py caller. `composite_tiles` launches the CUDA kernel (csrc/composite.cu)
for CUDA tensors and runs `composite_tiles_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from ... import kernels
from .binning import CONIC_A, CONIC_C, MEAN_X, MEAN_Y, OPACITY, RADIUS, GFEAT_WIDTH, TileLists
from .projection import gaussian_alpha
from .reference import TRANSMITTANCE_EPS


def _tiles_to_image(x: torch.Tensor, b: int, ntx: int, nty: int, tile: int, image_shape) -> torch.Tensor:
    """(B*T, tile*tile, C) in tile-major order -> (B, h, w, C) raster order."""
    c = x.shape[-1]
    x = x.reshape(b, nty, ntx, tile, tile, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, nty * tile, ntx * tile, c)
    return x[:, : image_shape[0], : image_shape[1]]


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

    Returns ((B, h, w, C) image, evaluations): evaluations counts the
    (pixel, list entry) pairs a compositor must visit before every tile
    saturates, i.e. the work the kernel needs on these inputs."""
    b, g, _ = gfeat.shape
    c = colors.shape[-1]
    ntx, nty = lists.num_tiles_x, lists.num_tiles_y
    t_count = ntx * nty
    p = tile * tile
    dev = gfeat.device
    start = lists.ranges[:, 0].long()
    length = (lists.ranges[:, 1] - lists.ranges[:, 0]).long()
    cells = b * t_count
    view = torch.arange(cells, device=dev) // t_count
    tile_id = torch.arange(cells, device=dev) % t_count
    lane = torch.arange(p, device=dev)
    px = ((tile_id % ntx) * tile)[:, None] + (lane % tile)[None]
    py = ((tile_id // ntx) * tile)[:, None] + (lane // tile)[None]
    pix = torch.stack([px, py], dim=-1).to(gfeat.dtype)[:, :, None, :]  # (cells, P, 1, 2)

    t_run = torch.ones((cells, p), dtype=gfeat.dtype, device=dev)
    acc = torch.zeros((cells, p, c), dtype=gfeat.dtype, device=dev)
    evaluations = 0
    max_len = int(length.max()) if cells else 0
    n_idx = lists.idx.shape[0]
    for k0 in range(0, max_len, chunk):
        kk = k0 + torch.arange(chunk, device=dev)
        mask = kk[None, :] < length[:, None]  # (cells, K)
        pos = torch.clamp(start[:, None] + kk[None, :], max=max(n_idx - 1, 0))
        gi = torch.where(mask, lists.idx[pos].long(), 0)
        f = gfeat[view[:, None], gi]  # (cells, K, 8)
        col = colors[view[:, None], gi]  # (cells, K, C)
        opacity = torch.where(mask, f[..., OPACITY], torch.zeros_like(f[..., OPACITY]))
        alpha = gaussian_alpha(
            f[:, None, :, CONIC_A : CONIC_C + 1],
            f[:, None, :, MEAN_X : MEAN_Y + 1],
            opacity[:, None, :],
            pix,
            f[:, None, :, RADIUS],
        )  # (cells, P, K)
        one_minus = 1.0 - alpha
        cum = torch.cumprod(one_minus, dim=-1)
        t_before = t_run[..., None] * torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]], dim=-1)
        live = t_before >= TRANSMITTANCE_EPS
        contrib = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
        acc = acc + torch.matmul(contrib, col)
        t_run = t_run * torch.prod(torch.where(live, one_minus, torch.ones_like(one_minus)), dim=-1)
        evaluations += int((live.any(dim=1) & mask).sum()) * p
    out = acc + t_run[..., None] * background[view][:, None, :]
    return _tiles_to_image(out, b, ntx, nty, tile, image_shape), evaluations


def composite_tiles(
    gfeat: torch.Tensor,
    colors: torch.Tensor,
    lists: TileLists,
    background: torch.Tensor,
    image_shape: tuple[int, int],
    tile: int = 16,
) -> torch.Tensor:
    """(B, h, w, C) composite of the tile lists over `background` (B, C)."""
    if not gfeat.is_cuda:
        return composite_tiles_plain(gfeat, colors, lists, background, image_shape, tile)[0]
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
    h, w = image_shape
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=gfeat.device)
    kernels.call(
        "tp_composite", "composite",
        gfeat.data_ptr(), colors.data_ptr(), lists.idx.data_ptr(), lists.ranges.data_ptr(),
        background.data_ptr(), out.data_ptr(), b, g, c, h, w, ntx, nty,
    )
    return out
