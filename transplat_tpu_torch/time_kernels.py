"""Device time of the hand-written kernels of this tree at the paths' shapes, in repeated readings.

    python -m transplat_tpu_torch.time_kernels [--readings 5] [--label NAME]

Run from the repository's root (it takes its inputs from chip_smoke.py).
Builds the Gaussians of one full-width serving request (chip_smoke.py's
seeded encoder and batch: 4 target views x 131,072 Gaussians, their tile
lists) and K5's inputs (2 pairs x 4096 queries of 64x64 score maps, D = 128,
random locations), then takes `--readings` readings in turns of:

- `deform_scores_p1` / `_p4`: K5 at P = 1 and 4 through
  `deform_sample_scores`, and `grid_sample` on the same inputs (at P = 4
  followed by the weighted sum over the points: the same function);
- `composite_bwd` and `bin_bwd`: one backward of `composite_tiles` (K4, then
  K2 in its atomic mode), through autograd; each kernel by its name;
- `index_add_`: the library's way to K2's function on the same rows.

Each reading is the median device time over 20 calls (utils/device_time.py).
Prints one JSON line with every reading and each item's median, min and
max. It uses only entry points whose signatures earlier trees share, so the
file can be copied into a parent tree (with utils/device_time.py) to compare
two trees in one call: parent, change, change, parent.
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
    """Projected, depth-sorted Gaussians of chip_smoke.py's request and their tile lists."""
    from .dataset import synthetic_batch
    from .inference import init_random, re10k_encoder_cfg
    from .model.encoder import EncoderTranSplat
    from .ops.rasterizer import api, binning

    encoder = EncoderTranSplat(re10k_encoder_cfg(), device="cuda")
    init_random(encoder, SEED)
    batch = synthetic_batch(SEED, batch_size=1, num_context=2, num_target=4, image_shape=IMAGE)
    ctx, tgt = batch["context"], batch["target"]
    with torch.no_grad():
        gaussians = encoder(*(torch.as_tensor(ctx[k], device=dev) for k in ("image", "intrinsics", "extrinsics", "near", "far")))
        views = tgt["extrinsics"].shape[1]
        rep = lambda x: x.expand(views, *x.shape[1:]).contiguous()  # noqa: E731
        cams = [torch.as_tensor(tgt[k][0], device=dev) for k in ("extrinsics", "intrinsics", "near")]
        proj = api.project_views(*cams, *(rep(x) for x in gaussians), IMAGE)
        gfeat, colors = binning.sort_by_depth(proj)
        lists = binning.bin_gaussians(gfeat, IMAGE)
    return gfeat, colors, lists


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--readings", type=int, default=5)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA card")
    from chip_smoke import deform_inputs

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
            f"deform_scores_p{p}.kernel_ms": (lambda: deform.deform_sample_scores(scores, (h, w), loc, aw), "deform_scores_kernel"),
            f"grid_sample_p{p}.device_ms": (sampled if p == 1 else lambda: (sampled().reshape(n, q, d, p) * aw).sum(-1), None),
        }

    gfeat, colors, lists = request_lists(dev)
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

    items = {
        **sampler_items(1),
        **sampler_items(4),
        "composite_bwd.kernel_ms": (backward, "composite_bwd_kernel"),
        "bin_bwd.kernel_ms": (backward, "bin_bwd_atomic_kernel"),
        "index_add_.device_ms": (lambda: torch.zeros((b * g, d_pair.shape[1]), device=dev).index_add_(0, rows, d_pair), None),
    }
    readings: dict[str, list[float]] = {k: [] for k in items}
    for _ in range(args.readings):
        for key, (fn, kernel) in items.items():
            t = device_time(fn, kernel)
            readings[key].append(t["kernel_ms"] if kernel else t["device_ms"])
    summary = {k: {"median": float(np.median(v)), "min": min(v), "max": max(v)} for k, v in readings.items()}
    print(json.dumps({
        "label": args.label, "device": torch.cuda.get_device_name(0), "pairs": int(lists.idx.shape[0]),
        "readings": readings, "summary": summary,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
