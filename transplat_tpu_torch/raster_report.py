"""Occupancy, per-block time and warp-level waste of the compositing kernels
(K3 `composite`, K4 `composite_bwd`) at the shapes of one serving request.

    python -m transplat_tpu_torch.raster_report [--label NAME] [--out outputs/raster_report.json]

Run from the repository's root on a card. It builds the Gaussians of
one seeded request (time_kernels.request_lists: 4 target views x
131,072 Gaussians and their tile lists) and reports, for K3 and K4:

- `regs`, `smem_bytes`, `local_bytes` (spills), `blocks_per_sm` and `waves`
  (the grid's blocks over blocks_per_sm x SMs) from cudaFuncGetAttributes and
  cudaOccupancyMaxActiveBlocksPerMultiprocessor, and what ptxas printed for
  the source (`-Xptxas -v`, kept beside the built library);
- the block times of the measuring instantiation (each block writes its
  start and end, %globaltimer in ns): median, p90, p99 and max, the span from
  the first start to the last end beside `kernel_ms` (torch.profiler, the
  main-path kernel alone), the correlation of a block's time with its tile's
  list length and visited length (the entries before the tile saturates,
  under the plain version's transmittance gate), and the slowest blocks;
- the warp-level waste of the lists: the share of (warp, entry) pairs in which
  no pixel of the warp's footprint lies inside the entry's conservative pixel
  rectangle (mean +- radius, one pixel of margin, clipped to the tile), for
  a 16x2 strip and an 8x4 block per warp, over all entries and over the
  visited ones; beside it the share in which no pixel passes the keep test
  at all (what a perfect warp-level cull would skip) and the share of
  (pixel, entry) evaluations that keep the entry;
- the work the function needs (`needed_work`): the evaluations before each
  tile saturates, those that no warp can cull, and the (pixel, entry) pairs
  that keep the entry while the pixel is live. time_kernels.py's
  `needed_bound_ms` of K3 and K4 is computed from the last two.

Prints one JSON line and writes it to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
from pathlib import Path

import numpy as np
import torch

from . import kernels
from .ops.rasterizer import binning, composite
from .ops.rasterizer.projection import gaussian_alpha

TILE = 16
THREADS = TILE * TILE
# Warp footprints (width, height) in pixels: the 16x2 strip and the 8x4 block.
FOOTPRINTS = {"16x2": (16, 2), "8x4": (8, 4)}


def kernel_attributes(kind: str, channels: int, blocks: int) -> dict:
    """Registers, shared memory, spills, resident blocks per SM and waves of
    the main-path instantiation of K3 (`composite`) or K4 (`composite_bwd`)."""
    info = (ctypes.c_int * 4)()
    kernels.query(f"tp_{kind}_attributes", channels, ctypes.addressof(info))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    regs, smem, local, per_sm = (int(x) for x in info)
    return dict(regs=regs, smem_bytes=smem, local_bytes=local, blocks_per_sm=per_sm, sms=sms,
                blocks=blocks, waves=blocks / max(per_sm * sms, 1))


def ptxas_lines(stem: str) -> list[str]:
    """ptxas' lines on the kernels of csrc/<stem>.cu (registers, spills, shared memory)."""
    keep = re.compile(r"Compiling entry|Function properties|registers|spill|bytes stack")
    return [line.strip() for line in kernels.ptxas_log(stem).splitlines() if keep.search(line)]


def gate_walk(gfeat, colors, lists: binning.TileLists, chunk: int = 64) -> tuple[torch.Tensor, int]:
    """Under the plain version's gate (composite._transmittance): (cells,)
    int64 entries of each tile's list before every pixel of the tile has
    T < 1e-4, and the number of (pixel, entry) pairs that keep the entry while
    the pixel is live (alpha > 0 and T_before >= 1e-4)."""
    view, start, length, pix = composite._cells(gfeat, lists, TILE)
    cells = view.shape[0]
    t_run = torch.ones((cells, THREADS), dtype=gfeat.dtype, device=gfeat.device)
    visited = torch.zeros(cells, dtype=torch.int64, device=gfeat.device)
    kept = torch.zeros((), dtype=torch.int64, device=gfeat.device)
    pos = torch.arange(1, chunk + 1, device=gfeat.device)
    for i, ch in enumerate(composite._chunks(gfeat, colors, lists, view, start, length, chunk)):
        opacity = torch.where(ch.mask, ch.f[..., binning.OPACITY], torch.zeros_like(ch.f[..., binning.OPACITY]))
        alpha = gaussian_alpha(
            ch.f[:, None, :, binning.CONIC_A : binning.CONIC_C + 1], ch.f[:, None, :, binning.MEAN_X : binning.MEAN_Y + 1],
            opacity[:, None, :], pix, ch.f[:, None, :, binning.RADIUS],
        )
        _, live = composite._transmittance(t_run, alpha)
        last = ((live.any(dim=1) & ch.mask) * pos).amax(dim=1)
        visited = torch.where(last > 0, i * chunk + last, visited)
        kept += (live & (alpha > 0)).sum()
        t_run = t_run * torch.prod(torch.where(live, 1.0 - alpha, torch.ones_like(alpha)), dim=-1)
    return visited, int(kept)


def _entry_cells(lists: binning.TileLists) -> torch.Tensor:
    """(N,) int64 cell (view * tiles + tile) of every list entry."""
    length = (lists.ranges[:, 1] - lists.ranges[:, 0]).long()
    cells = torch.arange(length.shape[0], device=length.device)
    return torch.repeat_interleave(cells, length, output_size=lists.idx.shape[0])


def _entries(gfeat, lists: binning.TileLists, visited: torch.Tensor):
    """Every list entry's geometry row (N, 8), its tile's origin (N,) x and y,
    and whether its tile visits it (N,) bool."""
    cell = _entry_cells(lists)
    t_count = lists.num_tiles_x * lists.num_tiles_y
    view, tile = cell // t_count, cell % t_count
    pos = torch.arange(lists.idx.shape[0], device=cell.device) - lists.ranges[cell, 0].long()
    f = gfeat[view, lists.idx.long()]
    ox = ((tile % lists.num_tiles_x) * TILE).to(f.dtype)
    oy = ((tile // lists.num_tiles_x) * TILE).to(f.dtype)
    return f, ox, oy, pos < visited[cell]


def needed_work(gfeat, colors, lists: binning.TileLists) -> dict:
    """What the compositing function needs on these lists, under the plain
    version's gate, in (pixel, entry) pairs: `evaluations` before each tile
    saturates (the plain compositor's count, which the bound of time_kernels.py
    charges in full); `unculled`, those of them whose warp's 8x4 footprint
    meets the entry's rectangle (the evaluations no warp can skip); `kept`,
    the pairs that keep the entry while the pixel is live (the only ones the
    blend and K4's gradient chain act on). Also `visited` (gate_walk)."""
    visited, kept = gate_walk(gfeat, colors, lists)
    f, ox, oy, seen = _entries(gfeat, lists, visited)
    mask = composite.warp_masks(composite.entry_rects(f[seen], ox[seen], oy[seen], TILE), FOOTPRINTS["8x4"], TILE)
    hits = sum(int(((mask >> w) & 1).sum()) for w in range(THREADS // 32))
    return {"visited": visited, "evaluations": int(visited.sum()) * THREADS, "unculled": hits * 32, "kept": kept}


def warp_waste(gfeat, lists: binning.TileLists, visited: torch.Tensor, batch: int = 32768) -> dict:
    """Shares of (warp, entry) pairs that a warp-level cull would skip (see the module docstring)."""
    f, ox, oy, seen = _entries(gfeat, lists, visited)
    rects = composite.entry_rects(f, ox, oy, TILE)  # the kernels' rectangles
    n_all, n_seen = max(int(seen.numel()), 1), max(int(seen.sum()), 1)
    out = {"entries": int(seen.numel()), "visited_entries": int(seen.sum())}
    for name, footprint in FOOTPRINTS.items():
        mask = composite.warp_masks(rects, footprint, TILE)
        hit = sum(((mask >> w) & 1) for w in range(THREADS // 32))
        miss = 1.0 - hit.double() / (THREADS // 32)
        out[f"rect_waste_{name}"] = float(miss.sum()) / n_all
        out[f"rect_waste_{name}_visited"] = float(miss[seen].sum()) / n_seen
    # The keep test itself, pixel by pixel: warps in which no pixel keeps the entry.
    lane = torch.arange(THREADS, device=f.device)
    exact = {name: [0.0, 0.0] for name in FOOTPRINTS}
    kept = [0, 0]
    for s in range(0, seen.numel(), batch):
        sl = slice(s, s + batch)
        fs = f[sl]
        for name, (fw, fh) in FOOTPRINTS.items():
            warp_x = TILE // fw
            wi, li = lane // 32, lane % 32
            px = ox[sl, None] + ((wi % warp_x) * fw + li % fw)[None].to(f.dtype)
            py = oy[sl, None] + ((wi // warp_x) * fh + li // fw)[None].to(f.dtype)
            alpha = gaussian_alpha(fs[:, None, binning.CONIC_A : binning.CONIC_C + 1], fs[:, None, :2],
                                   fs[:, None, binning.OPACITY], torch.stack([px, py], -1), fs[:, None, binning.RADIUS])
            keep = (alpha > 0).reshape(-1, THREADS // 32, 32)
            miss = (~keep.any(-1)).double().mean(-1)
            exact[name][0] += float(miss.sum())
            exact[name][1] += float(miss[seen[sl]].sum())
            if name == "16x2":
                kept[0] += int(keep.sum())
                kept[1] += int(keep[seen[sl]].sum())
    for name, (a, v) in exact.items():
        out[f"exact_waste_{name}"] = a / n_all
        out[f"exact_waste_{name}_visited"] = v / n_seen
    out["kept_share"] = kept[0] / (n_all * THREADS)
    out["kept_share_visited"] = kept[1] / (n_seen * THREADS)
    return out


def block_spread(launch, cells: int, lengths: torch.Tensor, visited: torch.Tensor, device, runs: int = 3) -> dict:
    """Per-block times of the measuring instantiation (the last of `runs`
    launches): spread, span, correlation with the tile's work, slowest blocks."""
    times = torch.zeros((cells, 2), dtype=torch.int64, device=device)
    for _ in range(runs):
        launch(times)
    torch.cuda.synchronize()
    t = times.cpu().numpy().astype(np.float64)
    dur = (t[:, 1] - t[:, 0]) / 1e3  # us
    first = t[:, 0].min()
    lens, vis = lengths.cpu().numpy(), visited.cpu().numpy()
    live = lens > 0

    def corr(a, b):
        return float(np.corrcoef(a, b)[0, 1]) if a.std() > 0 and b.std() > 0 else None

    slow = np.argsort(-dur)[:8]
    return {
        "block_us": {q: float(np.percentile(dur, p)) for q, p in (("median", 50), ("p90", 90), ("p99", 99), ("max", 100))},
        "block_us_mean": float(dur.mean()),
        "span_us": float((t[:, 1].max() - first) / 1e3),
        "last_start_us": float((t[:, 0].max() - first) / 1e3),
        "blocks_started_in_first_us": int(((t[:, 0] - first) < 1e3).sum()),
        "sum_block_us": float(dur.sum()),
        "corr_time_list_length": corr(dur[live], lens[live]),
        "corr_time_visited_length": corr(dur[live], vis[live]),
        "slowest": [dict(cell=int(i), us=float(dur[i]), start_us=float((t[i, 0] - first) / 1e3),
                         list_length=int(lens[i]), visited=int(vis[i])) for i in slow],
        "list_length": {"mean": float(lens.mean()), "max": int(lens.max()), "p99": float(np.percentile(lens, 99))},
        "visited_length": {"mean": float(vis.mean()), "max": int(vis.max()), "p99": float(np.percentile(vis, 99))},
    }


def composite_inputs(dev):
    """The request's lists and K4's inputs (coloured background, random cotangent), as time_kernels.py takes them."""
    from .time_kernels import IMAGE, SEED, request_lists

    gfeat, colors, lists, *_ = request_lists(dev)
    b, _, _ = gfeat.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bg = torch.rand((b, colors.shape[-1]), device=dev, generator=gen)
    g_out = torch.randn((b, *IMAGE, colors.shape[-1]), device=dev, generator=gen)
    return gfeat, colors, lists, bg, g_out, IMAGE


def kernel_report(gfeat, colors, lists, bg, g_out, image_shape, visited=None) -> dict:
    """Attributes and block-time spread of K3 and K4 on these inputs, beside their kernel_ms."""
    from .utils.device_time import device_time

    cells, c = lists.ranges.shape[0], colors.shape[-1]
    lengths = (lists.ranges[:, 1] - lists.ranges[:, 0]).long()
    if visited is None:
        visited, _ = gate_walk(gfeat, colors, lists)
    # K3 as a request runs it (cells in their own order), K4 as a training step does.
    order = composite.tile_order(lists)
    image, t_final = composite._composite_fwd_cuda(gfeat, colors, lists, bg, image_shape)
    d_pair = composite._composite_bwd_cuda(gfeat, colors, lists, bg, image, t_final, g_out, order=order)
    fwd = lambda bt=None: composite._composite_fwd_cuda(gfeat, colors, lists, bg, image_shape, block_times=bt)  # noqa: E731
    bwd = lambda bt=None: composite._composite_bwd_cuda(  # noqa: E731
        gfeat, colors, lists, bg, image, t_final, g_out, order=order, block_times=bt)
    timed_image, timed_t = fwd(torch.zeros((cells, 2), dtype=torch.int64, device=gfeat.device))
    timed_pair = bwd(torch.zeros((cells, 2), dtype=torch.int64, device=gfeat.device))
    same = torch.equal(timed_image, image) and torch.equal(timed_t, t_final) and torch.equal(timed_pair, d_pair)
    if not same:
        raise RuntimeError("raster_report: the measuring instantiation disagrees with the main-path kernel")
    out = {}
    for kind, fn, kernel in (("composite", fwd, "composite_kernel"), ("composite_bwd", bwd, "composite_bwd_kernel")):
        rec = kernel_attributes(kind, c, cells)
        rec["kernel_ms"] = device_time(fn, kernel)["kernel_ms"]
        rec.update(block_spread(fn, cells, lengths, visited, gfeat.device))
        out[kind] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="outputs/raster_report.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("raster_report: needs a CUDA card")
    kernels.strict_float32()
    dev = torch.device("cuda")
    kernels.load()
    gfeat, colors, lists, bg, g_out, image_shape = composite_inputs(dev)
    with torch.no_grad():
        work = needed_work(gfeat, colors, lists)
        visited = work.pop("visited")
        report = {
            "label": args.label, "device": torch.cuda.get_device_name(0),
            "pairs": int(lists.idx.shape[0]), "cells": int(lists.ranges.shape[0]), **work,
            "ptxas": {stem: ptxas_lines(stem) for stem in ("composite", "composite_bwd")},
            **kernel_report(gfeat, colors, lists, bg, g_out, image_shape, visited),
            "warp_waste": warp_waste(gfeat, lists, visited),
        }
    line = json.dumps(report)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
