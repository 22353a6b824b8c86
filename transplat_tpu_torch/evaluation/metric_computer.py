"""Offline metrics over methods' saved renders.

Counterpart of transplat_tpu/evaluation/metric_computer.py: loads the PNGs
that `main test --save-image` writes (<root>/<scene>/color/*.png) for N
methods, scores each scene against the ground truth's (PSNR, SSIM and, with
an `lpips_fn`, LPIPS; computed on `device`), averages per method into
summary.json, and optionally writes side-by-side panels (frame 0 of each
scene) and per-scene side-by-side videos.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..utils.image_io import load_image, save_image, save_video
from ..visualization.layout import add_label, hcat
from .metrics import compute_psnr, compute_ssim


@dataclass
class MetricComputerCfg:
    methods: dict = field(default_factory=dict)  # name -> directory of renders
    ground_truth: str = ""
    output_path: str = "outputs/metrics"
    side_by_side: bool = False
    # Per-scene side-by-side videos (mp4), at 30 fps (2 fps under 4 frames).
    animate_side_by_side: bool = False


class MetricComputer:
    def __init__(self, cfg: MetricComputerCfg, lpips_fn=None, device: str | torch.device = "cuda"):
        """lpips_fn: (pred, gt) image tensors (N, h, w, 3) on `device` -> (N,) distances, or None."""
        self.cfg = cfg
        self.lpips_fn = lpips_fn
        self.device = torch.device(device)
        self.scores: dict[str, dict[str, list]] = {m: {"psnr": [], "ssim": [], "lpips": []} for m in cfg.methods}

    def _scene_images(self, root: str | Path, scene: str) -> list[Path]:
        return sorted((Path(root) / scene / "color").glob("*.png"))

    @torch.no_grad()
    def process_scene(self, scene: str) -> None:
        gt_paths = self._scene_images(self.cfg.ground_truth, scene)
        if not gt_paths:
            return
        gt = np.stack([load_image(p) for p in gt_paths])
        gt_t = torch.from_numpy(gt).to(self.device)
        panels = []
        for method, root in self.cfg.methods.items():
            paths = self._scene_images(root, scene)
            if len(paths) != len(gt_paths):
                continue
            pred = np.stack([load_image(p) for p in paths])
            pred_t = torch.from_numpy(pred).to(self.device)
            self.scores[method]["psnr"].append(float(compute_psnr(gt_t, pred_t).mean()))
            self.scores[method]["ssim"].append(float(compute_ssim(gt_t, pred_t).mean()))
            if self.lpips_fn is not None:
                self.scores[method]["lpips"].append(float(self.lpips_fn(pred_t, gt_t).mean()))
            if self.cfg.side_by_side:
                panels.append((method, pred))
        if self.cfg.side_by_side and panels:
            # A row per frame (ground truth | each method); frame 0's row is the
            # scene's panel, all rows optionally a video.
            rows = [
                hcat(add_label(gt[i], "ground truth"), *[add_label(pred[i], m) for m, pred in panels])
                for i in range(len(gt))
            ]
            out = Path(self.cfg.output_path)
            save_image(rows[0], out / "side_by_side" / f"{scene}.png")
            if self.cfg.animate_side_by_side and len(rows) > 1:
                save_video(rows, out / "videos" / f"{scene}.mp4", fps=30 if len(rows) >= 4 else 2)

    def summarize(self) -> dict:
        """{method: {metric: mean over scenes}} of the metrics scored, also written to summary.json."""
        out = {
            method: {k: float(np.mean(v)) for k, v in score.items() if len(v) > 0}
            for method, score in self.scores.items()
        }
        path = Path(self.cfg.output_path)
        path.mkdir(parents=True, exist_ok=True)
        with open(path / "summary.json", "w") as f:
            json.dump(out, f, indent=2)
        return out
