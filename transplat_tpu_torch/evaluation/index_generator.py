"""Evaluation-index generation: pick context pairs by view overlap.

Counterpart of transplat_tpu/evaluation/index_generator.py: walk away from a
random starting frame until the mutual view overlap falls in [min_overlap,
max_overlap], then sample non-repeating target views inside the context
interval. Writes the schema of assets/evaluation_index_*.json; for the same
poses and seed the JSON equals the JAX package's
(tests/test_torch_cli.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..geometry.overlap import view_overlap


@dataclass
class IndexGeneratorCfg:
    num_target_views: int = 3
    min_overlap: float = 0.6
    max_overlap: float = 0.8
    min_distance: int = 45
    max_distance: int = 245
    seed: int = 123
    # Dense targets (every frame between the context pair), for video rendering.
    dense_targets: bool = False


class EvaluationIndexGenerator:
    def __init__(self, cfg: IndexGeneratorCfg, device: str | torch.device = "cuda"):
        """`device`: where the overlaps are computed."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.rng = np.random.default_rng(cfg.seed)
        self.index: dict[str, dict | None] = {}

    def _overlap(self, extrinsics: torch.Tensor, intrinsics: torch.Tensor, i: int, j: int) -> tuple[float, float]:
        a = float(view_overlap(extrinsics[i], intrinsics[i], extrinsics[j], intrinsics[j]))
        b = float(view_overlap(extrinsics[j], intrinsics[j], extrinsics[i], intrinsics[i]))
        return a, b

    def process_scene(self, scene: str, extrinsics: np.ndarray, intrinsics: np.ndarray) -> None:
        cfg = self.cfg
        v = len(extrinsics)
        extrinsics = torch.as_tensor(np.asarray(extrinsics, np.float32), device=self.device)
        intrinsics = torch.as_tensor(np.asarray(intrinsics, np.float32), device=self.device)
        for context_index in self.rng.permutation(v):
            valid = []
            for step in (1, -1):
                current = int(context_index) + step * cfg.min_distance
                while 0 <= current < v:
                    ov_a, ov_b = self._overlap(extrinsics, intrinsics, int(context_index), current)
                    overlap = min(ov_a, ov_b)
                    delta = abs(current - int(context_index))
                    if cfg.min_overlap <= overlap <= cfg.max_overlap:
                        valid.append(current)
                    if overlap < cfg.min_overlap or delta > cfg.max_distance:
                        break
                    current += step

            if valid:
                chosen = valid[int(self.rng.integers(len(valid)))]
                left = min(chosen, int(context_index))
                right = max(chosen, int(context_index))
                span = right - left + 1
                if span < cfg.num_target_views:
                    continue
                if cfg.dense_targets:
                    target = np.arange(left, right + 1)
                else:
                    target = self.rng.choice(np.arange(left, right + 1), cfg.num_target_views, replace=False)
                self.index[scene] = {"context": [left, right], "target": sorted(int(t) for t in target)}
                return
        self.index[scene] = None

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.index, f)
