"""Device time of the hand-written kernels of this tree at the paths' shapes, each beside its bound, in repeated readings.

    python -m transplat_tpu_torch.time_kernels [--readings 5] [--label NAME] [--items composite ...]

Needs a card. Runs one full-width re10k serving request (`request_lists`:
the re10k encoder with seeded random weights, a seeded synthetic batch: 2
context views -> 4 target views x 131,072 Gaussians and their tile lists;
tests/test_torch_cuda.py holds its kernels against their plain versions),
K5/K6's inputs (2 pairs x 4096 queries of 64x64 score maps, D = 128, random
locations), K7/K8's (2 pairs x 4096 queries of a 64x64x128 value map, P = 4,
self-attention-like locations), the Gaussian adapter stage's (1 x 256^2
views, SH 4) and the projection's (the request's Gaussians seen by 1 or 3
of its target cameras). Then it takes `--readings` readings in turns of
every row:

- K1 `bin_gaussians` (the whole: three kernels and the host read's copy),
  `bin_count`, `bin_scan`, `bin_place`;
- K2 `bin_bwd` (atomic mode), `bin_bwd_sorted` (the deterministic mode: its
  order and the segment sums), `bin_bwd_order` (the order alone);
- K3 `composite` (a request's forward) and `composite_train` (a forward that
  autograd records); K4 `composite_bwd`;
- K5 `deform_scores_p1` / `_p4`; K6 `deform_scores_bwd_p1` / `_p4`, and
  `deform_scores_bwd_p4_encoder` on the encoder's own cross-attention
  locations and scores (captured from the request);
- K7 `deform_vectors`; K8 `deform_vectors_bwd` (atomic mode),
  `deform_vectors_bwd_sorted` (the deterministic mode: keys, order, sums),
  `deform_vectors_bwd_order` (the counting sort alone);
- the adapter kernel `gaussian_adapter` (2 views), `gaussian_adapter_v3`
  (3 views) and `gaussian_adapter_s3` (2 views at pixelSplat's 3 Gaussians a
  pixel);
- the projection kernel `project_view` (1 camera x 131,072 Gaussians, SH 4),
  `project_serve` (3 x 131,072) and `project_pixelsplat` (3 x 393,216: the
  request's Gaussians three times over).

A reading of a row is `device_ms` (every device event of one call, fills
included) and `kernel_ms` (the hand-written kernels alone, by name) from
torch.profiler (utils/device_time.py, median of 20 calls), the same cold
(`device_cold_ms`, `kernel_cold_ms`: the L2 flushed before each call), and
`wrapper_ms` (median of one call between CUDA events, host work included).
Once a run, the row's plain version (`plain_ms`, between CUDA events) and
the library's way to the same function where there is one (`library_ms`,
device time; `library_wrapper_ms`).

Each row's bound is the larger of its bytes over 3.35 TB/s and its
operations over 67 TFLOP/s (H100 SXM: HBM3, float32 on the CUDA cores):
K5 and K6 count the 32-byte sectors of the score rows their in-map corners
touch, K7 and K8 the value rows; K3 and K4 charge every evaluation of the
plain compositor, and beside it `needed_bound_ms` counts the operations the
function needs (raster_report.needed_work). `share_of_bound_cold` is the
bound over the row's cold time (the kernels', else the device's).

Prints one JSON line a row (a row of several device events also splits
its cold time into them, `parts_cold`), with each reading's median, min and
max, then a line with the device and the run's label. `--items` keeps the rows whose
name starts with one of the given prefixes: a design trial, a patched copy
of the tree, reads the kernels it changed beside the tree it came from in
one call. The file and utils/device_time.py can be copied into a parent
tree to time two trees in turns in one call: parent, change, change,
parent.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.nn import functional as F

from . import kernels
from .utils.device_time import device_time

IMAGE = (256, 256)
SEED = 0
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM float32, CUDA cores
# The operations K3 and K4 need (`needed_bound_ms`, beside `bound_ms`, which
# charges 20 + 2C and 59 + 4C to every evaluation): the evaluation (16 of
# those: dx, dy, power, exp, alpha and the keep test) on the (pixel, entry)
# pairs whose warp cannot cull the entry, and what follows it on the pairs
# that keep the entry only: K3's blend (4 + 2C), K4's blend and gradient
# chain (43 + 4C).
NEEDED_OPS = {"composite": (16.0, lambda c: 4.0 + 2 * c), "composite_bwd": (16.0, lambda c: 43.0 + 4 * c)}


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median ms of fn() between CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least ms of a function of `nbytes` bytes and `flops` operations, and what bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def deform_inputs(dev, p: int):
    """K5/K6 inputs at the paths' shapes: 2 directed pairs x 4096 queries, 64x64 maps, D = 128."""
    n, q, d, h, w = 2, 4096, 128, 64, 64
    gen = torch.Generator(device=dev).manual_seed(SEED + p)
    scores = torch.randn((n, q, h * w), device=dev, generator=gen)
    loc = torch.rand((n, q, d, p, 2), device=dev, generator=gen) * 1.2 - 0.1
    loc[:, :, : d // 4] = torch.round(loc[:, :, : d // 4] * w) / w  # exact corner boundaries
    aw = torch.ones((n, q, d, p), device=dev) if p == 1 else torch.softmax(
        torch.randn((n, q, d, p), device=dev, generator=gen), dim=-1
    )
    gbar = torch.randn((n, q, d), device=dev, generator=gen)
    return scores, loc, aw, gbar, (n, q, d, h, w)


def vectors_inputs(dev):
    """K7/K8 inputs at the paths' shape: 2 directed pairs x 4096 queries of a
    64x64 map, C = 128, P = 4. Locations are the pixel centres plus small
    random offsets, as the self-attention produces them; an eighth sits on
    exact corner boundaries, an eighth around and outside the map's edge and a
    few far outside."""
    n, h, w, c, p = 2, 64, 64, 128, 4
    q = h * w
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    value = torch.randn((n, h * w, c), device=dev, generator=gen)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    centres = torch.stack([(xs + 0.5) / w, (ys + 0.5) / h], dim=-1).reshape(1, q, 1, 2)
    loc = centres + torch.randn((n, q, p, 2), device=dev, generator=gen) * (1.5 / w)
    loc[:, : q // 8] = torch.round(loc[:, : q // 8] * w) / w  # exact corner boundaries
    loc[:, q // 8 : q // 4] = torch.rand((n, q // 8, p, 2), device=dev, generator=gen) * 1.2 - 0.1
    loc[:, q // 4 : q // 4 + 16] = loc[:, q // 4 : q // 4 + 16] * 1e6  # far outside
    aw = torch.softmax(torch.randn((n, q, p), device=dev, generator=gen), dim=-1)
    gbar = torch.randn((n, q, c), device=dev, generator=gen)
    return value, loc.contiguous(), aw, gbar, (n, q, h, w, c, p)


def _corner_cells(loc: torch.Tensor, h: int, w: int):
    """The four bilinear corners of `loc` (..., 2) in [0, 1]: each as (x, y, inside the map)."""
    px = torch.floor(loc[..., 0] * w - 0.5).clamp(-2.0, w + 1.0).long()
    py = torch.floor(loc[..., 1] * h - 0.5).clamp(-2.0, h + 1.0).long()
    for dy in (0, 1):
        for dx in (0, 1):
            ix, iy = px + dx, py + dy
            yield ix, iy, (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)


def touched_sectors(loc: torch.Tensor, h: int, w: int) -> int:
    """32-byte sectors of the score rows that the in-range bilinear corners of
    `loc` (..., Q, D, P, 2) hit, counted per query row (rows are 32-byte
    aligned): the score bytes that K5 must read on these inputs."""
    rows = loc[..., 0].numel() // (loc.shape[-2] * loc.shape[-3])
    sectors = [torch.where(inside, (iy * w + ix) // 8, -1).reshape(rows, -1) for ix, iy, inside in _corner_cells(loc, h, w)]
    sec, _ = torch.sort(torch.cat(sectors, dim=1), dim=1)
    first = torch.ones_like(sec[:, :1], dtype=torch.bool)
    new = torch.cat([first, sec[:, 1:] != sec[:, :-1]], dim=1) & (sec >= 0)
    return int(new.sum())


def vectors_rows_touched(loc: torch.Tensor, n: int, h: int, w: int) -> int:
    """Rows of the value maps that the in-range corners of `loc` (N, Q, P, 2) hit."""
    pair = torch.arange(n, device=loc.device).reshape(n, 1, 1)
    hit = torch.zeros(n * h * w + 1, dtype=torch.bool, device=loc.device)
    for ix, iy, inside in _corner_cells(loc, h, w):
        hit[torch.where(inside, pair * h * w + iy * w + ix, n * h * w).reshape(-1)] = True
    return int(hit[:-1].sum())


def request_lists(dev) -> dict:
    """One full-width re10k serving request through `render_novel_views`,
    the kernels' launch counts reset just before it, and what the rows and
    the card tests take from it: `color` (its output), `launches` (its
    `kernels.launches`), `samplings` (P -> the inputs of its first score
    sampling with that P: the UV matcher's epipolar coarse correlation at
    P = 1, its first cross-attention at P = 4; scores (N, Q, HW), locations
    (N, Q, D, P, 2), weights (N, Q, D, P), map shape), `gaussians`, `cams`
    (the target extrinsics, intrinsics, near), and the Gaussians projected
    into its 4 target views, depth-sorted (`gfeat`, `colors`), with their
    tile lists (`lists`)."""
    from .dataset import synthetic_batch
    from .inference import init_random, re10k_encoder_cfg, render_novel_views
    from .model import uv_transformer
    from .model.encoder import EncoderTranSplat
    from .ops.rasterizer import binning, projection

    encoder = EncoderTranSplat(re10k_encoder_cfg(), device="cuda")
    init_random(encoder, SEED)
    batch = synthetic_batch(SEED, batch_size=1, num_context=2, num_target=4, image_shape=IMAGE)
    ctx, tgt = batch["context"], batch["target"]
    samplings = {}
    sample = uv_transformer.deform_sample_scores

    def capture(scores, hw, loc, aw, *args, **kw):
        p = loc.shape[-2]
        if p not in samplings:
            n, q, d, (h, w) = loc.shape[0], loc.shape[-4], loc.shape[-3], hw
            samplings[p] = (scores.detach().reshape(n, q, h * w).clone(), loc.detach().reshape(n, q, d, p, 2).clone(),
                            aw.detach().reshape(n, q, d, p).clone(), (h, w))
        return sample(scores, hw, loc, aw, *args, **kw)

    uv_transformer.deform_sample_scores = capture
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        color = render_novel_views(encoder, ctx, tgt, IMAGE, device=dev)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
    finally:
        uv_transformer.deform_sample_scores = sample
    with torch.no_grad():
        gaussians = encoder(*(torch.as_tensor(ctx[k], device=dev) for k in ("image", "intrinsics", "extrinsics", "near", "far")))
        views = tgt["extrinsics"].shape[1]
        rep = lambda x: x.expand(views, *x.shape[1:]).contiguous()  # noqa: E731
        cams = [torch.as_tensor(tgt[k][0], device=dev) for k in ("extrinsics", "intrinsics", "near")]
        proj = projection.project_views(*cams, *(rep(x) for x in gaussians), IMAGE)
        gfeat, colors = binning.sort_by_depth(proj)
        lists = binning.bin_gaussians(gfeat, IMAGE)
    return dict(color=color, launches=launches, samplings=samplings, gaussians=gaussians, cams=cams, gfeat=gfeat,
                colors=colors, lists=lists)


def adapter_inputs(dev, views: int, samples: int):
    """The adapter stage's configuration (SH 4, `samples` Gaussians a pixel)
    and its tensors (extrinsics, intrinsics, raw channels, depths,
    densities) at 1 x `views` views of 256^2: a seeded batch's context
    cameras, raw channels N(0, 1) laid out as the encoder's (one channel of
    consecutive pixels contiguous), depths in [0.5, 50], densities in (0, 1)."""
    from .dataset import synthetic_batch
    from .model.adapter import GaussianAdapterCfg
    from .model.encoder import EncoderCfg

    cfg = EncoderCfg(gaussian_adapter=GaussianAdapterCfg(sh_degree=4), gaussians_per_pixel=samples)
    ctx = synthetic_batch(SEED + views, batch_size=1, num_context=views, num_target=1, image_shape=IMAGE)["context"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 20 + views + samples)
    r = IMAGE[0] * IMAGE[1]
    raw = torch.randn((1, views, 2 + cfg.gaussian_adapter.d_in, r), device=dev, generator=gen).transpose(-1, -2)
    depth = torch.rand((1, views, r, samples), device=dev, generator=gen) * 49.5 + 0.5
    density = torch.rand((1, views, r, samples), device=dev, generator=gen)
    extr, intr = (torch.as_tensor(ctx[k], dtype=torch.float32, device=dev) for k in ("extrinsics", "intrinsics"))
    return cfg, (extr, intr, raw, depth, density)


def adapter_flops(degree: int) -> int:
    """Operations a Gaussian: the SH rotation's products and sums and its
    damping, and ~250 for the rays, opacity, scales, quaternion and the
    covariance's three 3x3 products."""
    return 3 * sum((2 * l + 1) * (4 * l + 1) + (2 * l + 1) for l in range(1, degree + 1)) + 250


def rows(dev, request) -> dict:
    """name -> the row's calls and counts on `request` (request_lists'):
    `fn` (one call), `kernel` (the hand-written kernels' event names contain
    it; None: the device time is the row's time), `bytes` and `flops` for the
    bound, `plain` and `library` (or None), and `extra` fields of its record."""
    from . import raster_report
    from .model.adapter import adapt_gaussians_fused
    from .model.encoder import adapt_stage_plain, opacity_exponent
    from .ops import deform
    from .ops.rasterizer import binning, composite
    from .ops.rasterizer.projection import project_rows_kernel, project_rows_plain
    from .training.step import repeatable_ops

    def deterministic(fn):
        def call():
            with repeatable_ops():
                return fn()
        return call

    gfeat, colors, lists, gs, cams = (request[k] for k in ("gfeat", "colors", "lists", "gaussians", "cams"))
    scores, loc, aw, (h, w) = request["samplings"][4]
    out = {}

    def row(name, fn, kernel, nbytes, flops, plain=None, library=None, **extra):
        out[name] = dict(fn=fn, kernel=kernel, bytes=float(nbytes), flops=float(flops), plain=plain, library=library,
                         extra=extra)

    # ---- the samplers, K5-K8 ----
    for p in (1, 4):
        sc, lo, we, gb, (n, q, d, mh, mw) = deform_inputs(dev, p)
        sectors = touched_sectors(lo, mh, mw)
        grid = (lo * 2.0 - 1.0).reshape(n * q, d, p, 2)
        img = sc.reshape(n * q, 1, mh, mw)
        sampled = lambda img=img, grid=grid: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",  # noqa: E731
                                                           align_corners=False)
        weighted = lambda sampled=sampled, we=we, n=n, q=q, d=d, p=p: (sampled().reshape(n, q, d, p) * we).sum(-1)  # noqa: E731
        row(f"deform_scores_p{p}", lambda s=sc, l=lo, a=we, hw=(mh, mw): deform.deform_sample_scores(s, hw, l, a),
            "deform_scores_kernel", 32 * sectors + 4 * (lo.numel() + we.numel() + n * q * d), n * q * d * p * 30.0,
            plain=lambda s=sc, l=lo, a=we, hw=(mh, mw): deform.deform_sample_scores_plain(s, hw, l, a),
            library=sampled if p == 1 else weighted, score_sectors_touched=sectors)
        # The library's way: autograd's backward of grid_sample + the weighted sum.
        lib_in = [t.clone().requires_grad_(True) for t in (img, grid, we)]
        lib_out = (F.grid_sample(lib_in[0], lib_in[1], mode="bilinear", padding_mode="zeros",
                                 align_corners=False).reshape(n, q, d, p) * lib_in[2]).sum(-1)
        row(f"deform_scores_bwd_p{p}",
            lambda s=sc, l=lo, a=we, g=gb, hw=(mh, mw): deform._scores_bwd_cuda(s, hw, l, a, g),
            "deform_scores_bwd_kernel",
            32 * sectors + 4 * (2 * lo.numel() + 2 * we.numel() + gb.numel() + sc.numel()), n * q * d * p * 60.0,
            plain=lambda s=sc, l=lo, a=we, g=gb, hw=(mh, mw): deform.deform_sample_scores_bwd_plain(s, hw, l, a, g),
            library=lambda o=lib_out, i=lib_in, g=gb: torch.autograd.grad(o, i, g, retain_graph=True),
            path=deform.scores_bwd_plan(mh, mw, d, p))
    gbar = torch.randn(loc.shape[:-2], device=dev, generator=torch.Generator(device=dev).manual_seed(SEED + 5))
    n, q, d, p = loc.shape[:4]
    row("deform_scores_bwd_p4_encoder", lambda: deform._scores_bwd_cuda(scores, (h, w), loc, aw, gbar),
        "deform_scores_bwd_kernel",
        32 * touched_sectors(loc, h, w) + 4 * (2 * loc.numel() + 2 * aw.numel() + gbar.numel() + scores.numel()),
        n * q * d * p * 60.0, shape=dict(pairs=n, q=q, d=d, p=p, h=h, w=w))

    value, vloc, vaw, vgbar, (vn, vq, vh, vw, vc, vp) = vectors_inputs(dev)
    touched = vectors_rows_touched(vloc, vn, vh, vw)
    lib_in = [t.clone().requires_grad_(True) for t in (value, vloc, vaw)]

    def grid_sample_vectors(value, loc, aw):
        """The library's way to K7's function: grid_sample on V as (N, C, H, W)
        with the Q x P grid, then the weighted sum over the points."""
        img = value.reshape(vn, vh, vw, vc).permute(0, 3, 1, 2)
        sampled = F.grid_sample(img, loc * 2.0 - 1.0, mode="bilinear", padding_mode="zeros", align_corners=False)
        return torch.einsum("ncqp,nqp->nqc", sampled, aw)

    lib_out = grid_sample_vectors(*lib_in)
    row("deform_vectors", lambda: deform.deform_sample_vectors(value, (vh, vw), vloc, vaw), "deform_vectors_kernel",
        4 * (touched * vc + vloc.numel() + vaw.numel() + vn * vq * vc), vn * vq * vp * 4 * (2.0 * vc + 12.0),
        plain=lambda: deform.deform_sample_vectors_plain(value, (vh, vw), vloc, vaw),
        library=lambda: grid_sample_vectors(value, vloc, vaw), value_rows_touched=touched)
    k8_bytes = 4 * (touched * vc + 2 * vloc.numel() + 2 * vaw.numel() + vgbar.numel() + value.numel())
    k8_flops = vn * vq * vp * 4 * (4.0 * vc + 20.0)
    k8_plain = lambda: deform.deform_sample_vectors_bwd_plain(value, (vh, vw), vloc, vaw, vgbar)  # noqa: E731
    row("deform_vectors_bwd", lambda: deform._vectors_bwd_cuda(value, (vh, vw), vloc, vaw, vgbar),
        "deform_vectors_bwd_kernel", k8_bytes, k8_flops, plain=k8_plain,
        library=lambda: torch.autograd.grad(lib_out, lib_in, vgbar, retain_graph=True))
    # The library's deterministic way to the sorted mode's d_value: index_add_
    # of the in-map corner rows under torch.use_deterministic_algorithms.
    keys, corner_w, _, _ = deform._vectors_bwd_launch(value, (vh, vw), vloc, vaw, vgbar, True)
    n_rows = vn * vh * vw
    inside = keys < n_rows
    contrib = corner_w[inside, None] * vgbar.reshape(-1, vc)[torch.nonzero(inside).squeeze(1) // (4 * vp)]
    row("deform_vectors_bwd_sorted", lambda: deform._vectors_bwd_cuda(value, (vh, vw), vloc, vaw, vgbar, deterministic=True),
        "deform_vectors_bwd", k8_bytes, k8_flops, plain=k8_plain,
        library=deterministic(lambda: torch.zeros((n_rows, vc), device=dev).index_add_(0, keys[inside].long(), contrib)))
    # The counting sort alone: the keys read once, perm and offsets written once.
    row("deform_vectors_bwd_order", lambda: deform.vectors_bwd_order(keys, vn, vh * vw), "deform_vectors_bwd",
        4 * (2 * keys.numel() + n_rows + 2), 0.0, plain=lambda: deform.vectors_bwd_order_plain(keys, n_rows),
        library=lambda: torch.sort(keys, stable=True))

    # ---- the rasterizer, K1-K4, on the request's lists ----
    b, g, _ = gfeat.shape
    c = colors.shape[-1]
    ntx, nty = lists.num_tiles_x, lists.num_tiles_y
    cells = b * ntx * nty
    total = int(lists.idx.numel())
    with torch.no_grad():
        table, rects, aux = binning.bin_count(gfeat, ntx, nty, 16)
        bases = table.clone()
        ranges = binning.bin_scan(bases, aux)
    table_bytes = 4 * table.numel()

    def scan_once():
        fresh = aux.clone()
        fresh[1] = 0  # bin_count zeroes the scan's count of finished blocks
        return binning.bin_scan(table.clone(), fresh)

    row("bin_gaussians", lambda: binning.bin_gaussians(gfeat, IMAGE), "bin_",
        4 * gfeat.numel() + 4 * total + 8 * cells + table_bytes, 0.0,
        library=lambda: binning.bin_gaussians_plain(gfeat, IMAGE))
    row("bin_count", lambda: binning.bin_count(gfeat, ntx, nty, 16), "bin_count_kernel",
        4 * gfeat.numel() + table_bytes + 8 * b * g, b * g * 40.0, plain=lambda: binning.bin_count_plain(gfeat, ntx, nty, 16))
    row("bin_scan", scan_once, "bin_scan_kernel", 2 * table_bytes + 8 * cells, table_bytes / 2.0,
        plain=lambda: binning.bin_scan_plain(table.clone(), aux.clone()))
    row("bin_place", lambda: binning.bin_place(rects, bases, ranges, total, ntx, nty), "bin_place_kernel",
        8 * b * g + table_bytes + 8 * cells + 4 * total, 10.0 * total,
        plain=lambda: binning.bin_place_plain(rects, bases, ranges, total, ntx, nty))

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bg = torch.rand((b, c), device=dev, generator=gen)
    g_out = torch.randn((b, *IMAGE, c), device=dev, generator=gen)
    order = composite.tile_order(lists)
    image, t_final = composite._composite_fwd_cuda(gfeat, colors, lists, bg, IMAGE, order=order)
    image_p, t_final_p, evaluations = composite.composite_tiles_plain(gfeat, colors, lists, bg, IMAGE)
    d_pair = composite._composite_bwd_cuda(gfeat, colors, lists, bg, image, t_final, g_out, order=order)
    with torch.no_grad():
        work = raster_report.needed_work(gfeat, colors, lists)
    work.pop("visited")
    k3_bytes = 4 * (gfeat.numel() + colors.numel() + total + 2 * cells + bg.numel() + image.numel())

    def needed(name):
        eval_ops, kept_ops = NEEDED_OPS[name]
        return bound(0.0, work["unculled"] * eval_ops + work["kept"] * kept_ops(c))[0]

    def forward():
        with torch.no_grad():
            return composite.composite_tiles(gfeat, colors, lists, bg, IMAGE)

    leaves = [t.clone().requires_grad_(True) for t in (gfeat, colors)]
    k3_plain = lambda: composite.composite_tiles_plain(gfeat, colors, lists, bg, IMAGE)  # noqa: E731
    row("composite", forward, "composite_kernel", k3_bytes, evaluations * (20.0 + 2 * c), plain=k3_plain,
        needed_bound_ms=needed("composite"), work=work, evaluations=evaluations)
    row("composite_train", lambda: composite.composite_tiles(*leaves, lists, bg, IMAGE), "composite_kernel", k3_bytes,
        evaluations * (20.0 + 2 * c), plain=k3_plain, needed_bound_ms=needed("composite"))
    # K4: the forward's evaluations, each with the gradient chain (~59 + 4C
    # operations: the forward's 20, <g, c>, d_alpha, the seven products, and
    # one add per value for the sum over pixels).
    row("composite_bwd", lambda: composite._composite_bwd_cuda(gfeat, colors, lists, bg, image, t_final, g_out, order=order),
        "composite_bwd_kernel",
        4 * (gfeat.numel() + colors.numel() + total + 2 * cells + bg.numel() + 2 * image.numel() + t_final.numel()
             + total * (8 + c)),
        evaluations * (59.0 + 4 * c),
        plain=lambda: composite.composite_tiles_bwd_plain(gfeat, colors, lists, bg, image_p, t_final_p, g_out),
        needed_bound_ms=needed("composite_bwd"))
    # K2: d_pair and idx in, (B, G, 8 + C) out (the bound counts 8 + C columns, not the padded row).
    pair_rows = binning._pair_rows(lists, b, g)
    k2_bytes, k2_flops = 4 * (total * (8 + c) + total + b * g * (8 + c)), float(total * (8 + c))
    index_add = lambda: torch.zeros((b * g, d_pair.shape[1]), device=dev).index_add_(0, pair_rows, d_pair)  # noqa: E731
    row("bin_bwd", lambda: binning.bin_bwd(d_pair, lists, b, g, c), "bin_bwd_atomic_kernel", k2_bytes, k2_flops,
        plain=lambda: binning.bin_bwd_plain(d_pair, lists, b, g, c), library=index_add)
    row("bin_bwd_sorted", lambda: binning.bin_bwd(d_pair, lists, b, g, c, deterministic=True), "bin_bwd_",
        k2_bytes, k2_flops, plain=lambda: binning.bin_bwd_sorted_plain(d_pair, *binning.bin_bwd_order_plain(lists, b, g)),
        library=deterministic(index_add))
    # Its order alone: idx, ranges and the packed rectangles read once, perm and offsets written once.
    row("bin_bwd_order", lambda: binning.bin_bwd_order(lists, b, g), "bin_bwd_",
        4 * (2 * total + 2 * cells + 3 * b * g + 1), 0.0, plain=lambda: binning.bin_bwd_order_plain(lists, b, g),
        library=lambda: torch.sort(pair_rows, stable=True))

    # ---- the Gaussian adapter stage's kernel: raw channels read once a pixel, every Gaussian written ----
    step = 50
    for name, views, samples in (("gaussian_adapter", 2, 1), ("gaussian_adapter_v3", 3, 1), ("gaussian_adapter_s3", 2, 3)):
        cfg, tensors = adapter_inputs(dev, views, samples)
        count = views * IMAGE[0] * IMAGE[1] * samples
        out_floats = 3 + 9 + 3 * cfg.gaussian_adapter.d_sh + 1
        exponent = opacity_exponent(cfg.opacity_mapping, step)
        row(name, lambda cfg=cfg, t=tensors, e=exponent, s=samples: adapt_gaussians_fused(cfg.gaussian_adapter, *t, e, s, IMAGE),
            "gaussian_adapter_kernel", 4 * (sum(t.numel() for t in tensors) + count * out_floats), count * adapter_flops(4),
            plain=lambda cfg=cfg, t=tensors: adapt_stage_plain(cfg, *t, step, IMAGE), gaussians=count)

    # ---- the projection kernel: 88 floats a Gaussian read once a set, 13 written a camera ----
    for name, views, copies in (("project_view", 1, 1), ("project_serve", 3, 1), ("project_pixelsplat", 3, 3)):
        args = (*(x[:views].contiguous() for x in cams), *(torch.cat([x] * copies, 1).contiguous() for x in gs))
        count = gs.means.shape[1] * copies
        row(name, lambda args=args: project_rows_kernel(*args, IMAGE), "project_kernel",
            4 * (count * (3 + 9 + 75 + 1) + views * count * (1 + 8 + 3 + 1) + views * (16 + 9 + 1)), views * count * 400,
            plain=lambda args=args: project_rows_plain(*args, IMAGE), gaussians=count, cameras=views)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--readings", type=int, default=5)
    ap.add_argument("--label", default="")
    ap.add_argument("--items", nargs="*", default=None, help="prefixes of the rows to read (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA card")
    kernels.strict_float32()
    dev = torch.device("cuda")
    request = request_lists(dev)
    table = rows(dev, request)
    if args.items is not None:
        table = {k: v for k, v in table.items() if k.startswith(tuple(args.items))}
    readings = {k: {} for k in table}
    info = {k: {"attempts": [], "events": []} for k in table}
    for _ in range(args.readings):
        for name, r in table.items():
            warm, cold = device_time(r["fn"], r["kernel"]), device_time(r["fn"], r["kernel"], cold=True)
            for m, t in (("device_ms", warm["device_ms"]), ("kernel_ms", warm["kernel_ms"]),
                         ("device_cold_ms", cold["device_ms"]), ("kernel_cold_ms", cold["kernel_ms"]),
                         ("wrapper_ms", time_ms(r["fn"]))):
                if t is not None:
                    readings[name].setdefault(m, []).append(t)
            info[name]["attempts"] += [warm["attempts"], cold["attempts"]]
            info[name]["events"].append(cold["events"])
            info[name]["launches"] = warm["device_launches"]
    for name, r in table.items():
        b_ms, b_by = bound(r["bytes"], r["flops"])
        summary = {m: {"median": float(np.median(v)), "min": float(np.min(v)), "max": float(np.max(v))}
                   for m, v in readings[name].items()}
        ms = summary["kernel_cold_ms" if r["kernel"] else "device_cold_ms"]["median"]
        rec = {"name": name, "bound_ms": b_ms, "bound_by": b_by, "bytes": r["bytes"], "operations": r["flops"],
               "share_of_bound_cold": b_ms / ms, "launches": info[name]["launches"], "kernel_is": r["kernel"],
               **{m: s["median"] for m, s in summary.items()}, "summary": summary, "readings": readings[name],
               "attempts": info[name]["attempts"], **r["extra"]}
        events = info[name]["events"]
        if len(events[0]) > 1:  # a row of several device events: each event's median cold ms over the readings
            rec["parts_cold"] = [[ev[:80], float(np.median([e[i][1] for e in events]))] for i, (ev, _) in enumerate(events[0])]
        if r["plain"] is not None:
            rec["plain_ms"] = time_ms(r["plain"], iters=3, warmup=1)
        if r["library"] is not None:
            rec["library_wrapper_ms"] = time_ms(r["library"])
            rec["library_ms"] = device_time(r["library"])["device_ms"]
        print(json.dumps(rec), flush=True)
    print(json.dumps({"label": args.label, "device": torch.cuda.get_device_name(0), "pairs": int(request["lists"].idx.numel()),
                      "readings": args.readings, "rows": list(table), "at": time.strftime("%Y-%m-%dT%H:%M:%S")}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
