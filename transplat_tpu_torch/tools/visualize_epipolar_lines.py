"""Visualize epipolar sample lines between two context views.

Counterpart of scripts/visualize_epipolar_lines.py (the reference's
src/scripts/visualize_epipolar_lines.py): for a few query pixels of view A,
draw in view B where the plane sweep samples them (the depth candidates'
projections, geometry/epipolar.py), the geometry the UV cost-volume
attention samples along. One PNG per scene, A | B, under --out.

    python -m transplat_tpu_torch.tools.visualize_epipolar_lines [--experiment re10k]
        [--dataset-root D] [--evaluation-index I] [--num-pixels 6] [--num-depths 32]
        [--out outputs/epipolar] [--max-scenes 4] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..config import BoundedCfg, load_config
from ..dataset.re10k import ChunkDataset
from ..dataset.view_samplers import ViewSamplerBounded, ViewSamplerEvaluation
from ..geometry.epipolar import epipolar_sample_grid, inverse_depth_candidates, relative_pose
from ..geometry.projection import unnormalize_intrinsics
from ..utils.image_io import save_image
from ..visualization.color_map import apply_color_map
from ..visualization.layout import hcat


def sample_grid(context: dict, num_depths: int, device) -> np.ndarray:
    """(D, H * W, 2) in [0, 1]: every pixel of context view 0 at `num_depths`
    depths, spaced in inverse depth between near and far, seen from view 1."""
    h, w = context["image"].shape[1:3]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    intr_px = unnormalize_intrinsics(t(context["intrinsics"][0]), (h, w))
    rel = relative_pose(t(context["extrinsics"][0]), t(context["extrinsics"][1]))
    depths = 1.0 / inverse_depth_candidates(t(context["near"][0]), t(context["far"][0]), num_depths)
    return epipolar_sample_grid(intr_px, rel, depths, h, w).cpu().numpy()


def draw(context: dict, grid: np.ndarray, rng: np.random.Generator, num_pixels: int):
    """Views A and B with `num_pixels` query pixels (drawn from `rng` in the
    middle half of A, a 5x5 mark each) and their samples in B, one colour
    per query. Returns (A, B, [(y, x), ...])."""
    h, w = context["image"].shape[1:3]
    img_a, img_b = context["image"][0].copy(), context["image"][1].copy()
    queries = []
    for p in range(num_pixels):
        py = int(rng.integers(h // 4, 3 * h // 4))
        px = int(rng.integers(w // 4, 3 * w // 4))
        queries.append((py, px))
        color = apply_color_map(np.asarray([p / num_pixels]))[0]
        img_a[max(py - 2, 0) : py + 3, max(px - 2, 0) : px + 3] = color
        q = py * w + px
        for d in range(grid.shape[0]):
            x = grid[d, q, 0] * (w - 1)
            y = grid[d, q, 1] * (h - 1)
            if 0 <= x < w and 0 <= y < h:
                img_b[int(y), int(x)] = color
    return img_a, img_b, queries


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m transplat_tpu_torch.tools.visualize_epipolar_lines",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--experiment", default="re10k")
    parser.add_argument("--dataset-root", default=None, help="default: the experiment's dataset roots")
    parser.add_argument("--evaluation-index", default=None)
    parser.add_argument("--num-pixels", type=int, default=6)
    parser.add_argument("--num-depths", type=int, default=32)
    parser.add_argument("--out", default="outputs/epipolar")
    parser.add_argument("--max-scenes", type=int, default=4)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to compute on the CPU")
    cfg = load_config(args.experiment)
    if args.dataset_root:
        cfg.dataset.roots = [args.dataset_root]
    if args.evaluation_index:
        sampler = ViewSamplerEvaluation(args.evaluation_index)
    else:
        sampler = ViewSamplerBounded(BoundedCfg(warm_up_steps=0), stage="test")
    dataset = ChunkDataset(cfg.dataset, "test", sampler)

    out_dir = Path(args.out)
    rng = np.random.default_rng(0)
    for i, example in enumerate(dataset):
        if i >= args.max_scenes:
            break
        ctx = example["context"]
        grid = sample_grid(ctx, args.num_depths, args.device)
        img_a, img_b, _ = draw(ctx, grid, rng, args.num_pixels)
        save_image(hcat(img_a, img_b), out_dir / f"{example['scene']}.png")
        print(f"wrote {out_dir / example['scene']}.png", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
