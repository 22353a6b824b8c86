"""Device time of the hand-written kernels of this tree at the paths' shapes, in repeated readings.

    python -m transplat_tpu_torch.time_kernels [--readings 5] [--label NAME] [--items composite ...]

Run from the repository's root (it takes its inputs from chip_smoke.py).
Builds the Gaussians of one full-width serving request (chip_smoke.py's
seeded encoder and batch: 4 target views x 131,072 Gaussians, their tile
lists) and K5's inputs (2 pairs x 4096 queries of 64x64 score maps, D = 128,
random locations), then takes `--readings` readings in turns of:

- `deform_scores_p1` / `_p4`: K5 at P = 1 and 4 through
  `deform_sample_scores`, and `grid_sample` on the same inputs (at P = 4
  followed by the weighted sum over the points: the same function);
- `composite`: one forward of `composite_tiles` (K3) without autograd, as a
  request runs it; `composite_train`: one forward that autograd records, as
  a training step runs it (the tiles longest list first, where the tree
  orders them);
- `composite_bwd` and `bin_bwd`: one backward of `composite_tiles` (K4, then
  K2 in its atomic mode), through autograd; each kernel by its name;
- `index_add_`: the library's way to K2's function on the same rows;
- `deform_scores_bwd_p1` / `_p4`: K6 on K5's inputs with a random d out, and
  `deform_scores_bwd_p4_encoder` on the locations and scores of the
  encoder's own cross-attention (captured from the request);
- `deform_vectors_bwd`: K8's atomic mode, `deform_vectors_bwd_sorted` its
  sorted, deterministic mode (device time, the sort included), on
  chip_smoke.py's self-attention-like value-sampler inputs;
- `bin_gaussians`: the whole of K1, from the depth-sorted rows to `idx` and
  `ranges`, on the request's Gaussians: every device event of one call, warm
  and cold, split into its parts (`parts`: each event's name and its median
  share over the readings), and `bin_gaussians.wrapper_ms`, one call between
  CUDA events with its host read of the total;
- `deform_vectors` (K7) on the self-attention-like value-sampler inputs,
  device time warm and cold, and its wrapper time;
- `deform_vectors_bwd` and `bin_bwd` (K2's atomic mode, called directly)
  with the L2 flushed before each call (`.kernel_cold_ms`): their bytes fit
  in the 50 MB L2, where back-to-back calls find them.

Each reading is the median device time over 20 calls (utils/device_time.py).
`--items` keeps the items whose name starts with one of the given prefixes:
a design trial, a patched copy of the tree, reads the kernels it changed
beside the tree it came from in one call. Prints one JSON line with every
reading, each item's median, min and max, and the profiler traces each
reading took (`attempts`; more than 1 where a trace came back short). It
uses only entry points whose signatures earlier trees share, so the file can
be copied into a parent tree (with utils/device_time.py) to compare two
trees in one call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch.nn import functional as F

from .utils.device_time import device_time

IMAGE = (256, 256)
SEED = 0


def request_lists(dev):
    """Projected, depth-sorted Gaussians of chip_smoke.py's request and their
    tile lists, and the inputs of the request's first P = 4 score sampling
    (the cross-attention): scores, locations, weights, map shape."""
    from .dataset import synthetic_batch
    from .inference import init_random, re10k_encoder_cfg
    from .model import uv_transformer
    from .model.encoder import EncoderTranSplat
    from .ops.rasterizer import api, binning

    encoder = EncoderTranSplat(re10k_encoder_cfg(), device="cuda")
    init_random(encoder, SEED)
    batch = synthetic_batch(SEED, batch_size=1, num_context=2, num_target=4, image_shape=IMAGE)
    ctx, tgt = batch["context"], batch["target"]
    seen = []
    sample = uv_transformer.deform_sample_scores

    def capture(scores, hw, loc, aw, *args, **kw):
        if loc.shape[-2] == 4 and not seen:
            seen.append((scores.detach().clone(), loc.detach().clone(), aw.detach().clone(), tuple(hw)))
        return sample(scores, hw, loc, aw, *args, **kw)

    uv_transformer.deform_sample_scores = capture
    try:
        with torch.no_grad():
            gaussians = encoder(*(torch.as_tensor(ctx[k], device=dev) for k in ("image", "intrinsics", "extrinsics", "near", "far")))
    finally:
        uv_transformer.deform_sample_scores = sample
    with torch.no_grad():
        views = tgt["extrinsics"].shape[1]
        rep = lambda x: x.expand(views, *x.shape[1:]).contiguous()  # noqa: E731
        cams = [torch.as_tensor(tgt[k][0], device=dev) for k in ("extrinsics", "intrinsics", "near")]
        proj = api.project_views(*cams, *(rep(x) for x in gaussians), IMAGE)
        gfeat, colors = binning.sort_by_depth(proj)
        lists = binning.bin_gaussians(gfeat, IMAGE)
    return gfeat, colors, lists, seen[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--readings", type=int, default=5)
    ap.add_argument("--label", default="")
    ap.add_argument("--items", nargs="*", default=None, help="prefixes of the items to read (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA card")
    from chip_smoke import deform_inputs, time_ms, vectors_inputs

    from .ops import deform
    from .ops.rasterizer import binning, composite

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def sampler_items(p: int) -> dict:
        scores, loc, aw, _, (n, q, d, h, w) = deform_inputs(dev, p)
        grid = (loc * 2.0 - 1.0).reshape(n * q, d, p, 2)
        img = scores.reshape(n * q, 1, h, w)
        sampled = lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False)  # noqa: E731
        return {
            f"deform_scores_p{p}.kernel_ms":
                (lambda: deform.deform_sample_scores(scores, (h, w), loc, aw), "deform_scores_kernel", False),
            f"grid_sample_p{p}.device_ms":
                (sampled if p == 1 else lambda: (sampled().reshape(n, q, d, p) * aw).sum(-1), None, False),
        }

    gfeat, colors, lists, cross = request_lists(dev)
    b, g, _ = gfeat.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bg = torch.rand((b, colors.shape[-1]), device=dev, generator=gen)
    g_out = torch.randn((b, *IMAGE, colors.shape[-1]), device=dev, generator=gen)
    leaves = [t.clone().requires_grad_(True) for t in (gfeat, colors)]
    image = composite.composite_tiles(leaves[0], leaves[1], lists, bg, IMAGE)
    backward = lambda: torch.autograd.grad(image, leaves, g_out, retain_graph=True)  # noqa: E731
    # The library's K2: the same rows (views * G + idx) added by index_add_ into a zeroed buffer.
    counts = (lists.ranges[:, 1] - lists.ranges[:, 0]).long().reshape(b, -1).sum(1)
    rows = torch.repeat_interleave(torch.arange(b, device=dev), counts) * g + lists.idx.long()
    width = 8 + 4 * ((colors.shape[-1] + 3) // 4)  # K2's padded gradient row
    d_pair = torch.randn((lists.idx.shape[0], width), device=dev, generator=gen)

    def forward():
        with torch.no_grad():
            return composite.composite_tiles(gfeat, colors, lists, bg, IMAGE)

    def scores_bwd_items(p: int, inputs=None, suffix: str = "") -> dict:
        if inputs is None:
            scores, loc, aw, gbar, (_, _, _, h, w) = deform_inputs(dev, p)
        else:
            scores, loc, aw, (h, w) = inputs
            gbar = torch.randn(loc.shape[:-2], device=dev, generator=torch.Generator(device=dev).manual_seed(SEED + 5))
        return {f"deform_scores_bwd_p{p}{suffix}.kernel_ms":
                (lambda: deform._scores_bwd_cuda(scores, (h, w), loc, aw, gbar), "deform_scores_bwd", False)}

    value, vloc, vaw, vgbar, (_, _, vh, vw, _, _) = vectors_inputs(dev)
    ntx, nty = lists.num_tiles_x, lists.num_tiles_y
    # name -> (function, kernel name or None for the device time, L2 flushed before each call)
    items = {
        **sampler_items(1),
        **sampler_items(4),
        "composite.kernel_ms": (forward, "composite_kernel", False),
        "composite_train.kernel_ms": (lambda: composite.composite_tiles(*leaves, lists, bg, IMAGE), "composite_kernel", False),
        "composite_bwd.kernel_ms": (backward, "composite_bwd_kernel", False),
        "bin_bwd.kernel_ms": (backward, "bin_bwd_atomic_kernel", False),
        "index_add_.device_ms": (lambda: torch.zeros((b * g, d_pair.shape[1]), device=dev).index_add_(0, rows, d_pair), None, False),
        **scores_bwd_items(1),
        **scores_bwd_items(4),
        **scores_bwd_items(4, cross, "_encoder"),
        "deform_vectors_bwd.kernel_ms":
            (lambda: deform._vectors_bwd_cuda(value, (vh, vw), vloc, vaw, vgbar), "deform_vectors_bwd_kernel", False),
        "deform_vectors_bwd_sorted.device_ms":
            (lambda: deform._vectors_bwd_cuda(value, (vh, vw), vloc, vaw, vgbar, deterministic=True), None, False),
        "bin_gaussians.device_ms": (lambda: binning.bin_gaussians(gfeat, IMAGE), None, False),
        "bin_gaussians.device_cold_ms": (lambda: binning.bin_gaussians(gfeat, IMAGE), None, True),
        "deform_vectors.device_ms": (lambda: deform.deform_sample_vectors(value, (vh, vw), vloc, vaw), None, False),
        "deform_vectors.device_cold_ms": (lambda: deform.deform_sample_vectors(value, (vh, vw), vloc, vaw), None, True),
        "deform_vectors_bwd.kernel_cold_ms":
            (lambda: deform._vectors_bwd_cuda(value, (vh, vw), vloc, vaw, vgbar), "deform_vectors_bwd_kernel", True),
        "bin_bwd.kernel_cold_ms": (lambda: binning.bin_bwd(d_pair, lists, b, g, colors.shape[-1]), "bin_bwd_atomic_kernel", True),
    }
    # name -> function: one call between CUDA events, host work included
    wrappers = {
        "bin_gaussians.wrapper_ms": lambda: binning.bin_gaussians(gfeat, IMAGE),
        "deform_vectors.wrapper_ms": lambda: deform.deform_sample_vectors(value, (vh, vw), vloc, vaw),
    }
    if args.items is not None:
        items = {k: v for k, v in items.items() if k.startswith(tuple(args.items))}
        wrappers = {k: v for k, v in wrappers.items() if k.startswith(tuple(args.items))}
    readings: dict[str, list[float]] = {k: [] for k in (*items, *wrappers)}
    attempts: dict[str, list[int]] = {k: [] for k in items}
    events: dict[str, list[list]] = {k: [] for k in items}
    for _ in range(args.readings):
        for key, (fn, kernel, cold) in items.items():
            t = device_time(fn, kernel, cold=cold)
            readings[key].append(t["kernel_ms"] if kernel else t["device_ms"])
            attempts[key].append(t["attempts"])
            events[key].append(t["events"])
        for key, fn in wrappers.items():
            readings[key].append(time_ms(fn))
    # The parts of each multi-event item: every event's median ms over the readings and its share.
    parts = {}
    for key, per_reading in events.items():
        if per_reading and len(per_reading[0]) > 1:
            ms = [float(np.median([r[i][1] for r in per_reading])) for i in range(len(per_reading[0]))]
            parts[key] = [{"event": name[:80], "ms": m, "share": m / max(sum(ms), 1e-12)}
                          for (name, _), m in zip(per_reading[0], ms)]
    summary = {k: {"median": float(np.median(v)), "min": min(v), "max": max(v)} for k, v in readings.items()}
    print(json.dumps({
        "label": args.label, "device": torch.cuda.get_device_name(0), "pairs": int(lists.idx.shape[0]),
        "readings": readings, "attempts": attempts, "summary": summary, "parts": parts,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
