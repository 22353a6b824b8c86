"""View samplers: bounded (curriculum), evaluation (index JSON), arbitrary, all.

Own copy of transplat_tpu/dataset/view_samplers.py, in numpy: every sampler
takes an explicit np.random.Generator and, from the same generator state,
returns the same indices as the JAX package's (tests/test_torch_dataset.py).
The curriculum's step is a `global_step` argument that the data loader
threads through.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..config import BoundedCfg


class ViewSamplerBounded:
    """Context gap scheduled from an initial to a final range over
    `warm_up_steps`; targets drawn between the two context views."""

    def __init__(self, cfg: BoundedCfg, stage: str = "train", cameras_are_circular: bool = False):
        self.cfg = cfg
        self.stage = stage
        self.circular = cameras_are_circular

    def _schedule(self, initial: int, final: int, global_step: int) -> int:
        fraction = global_step / self.cfg.warm_up_steps
        return min(initial + int((final - initial) * fraction), final)

    def sample(self, scene: str, num_views: int, rng: np.random.Generator, global_step: int = 0):
        cfg = self.cfg
        if self.stage == "test":
            max_gap = min_gap = cfg.max_distance_between_context_views
        elif cfg.warm_up_steps > 0:
            max_gap = self._schedule(
                cfg.initial_max_distance_between_context_views, cfg.max_distance_between_context_views, global_step
            )
            min_gap = self._schedule(
                cfg.initial_min_distance_between_context_views, cfg.min_distance_between_context_views, global_step
            )
        else:
            max_gap = cfg.max_distance_between_context_views
            min_gap = cfg.min_distance_between_context_views

        # pixelSplat's quirk, kept for the same sampling statistics: max_gap
        # is clamped through min_gap's value.
        if not self.circular:
            max_gap = min(num_views - 1, min_gap)
        min_gap = max(2 * cfg.min_distance_to_context_views, min_gap)
        if max_gap < min_gap:
            raise ValueError("Example does not have enough frames!")

        context_gap = int(rng.integers(min_gap, max_gap + 1))
        hi = num_views if self.circular else num_views - context_gap
        left = int(rng.integers(hi))
        if self.stage == "test":
            left = 0
        right = left + context_gap

        if self.stage == "test":
            target = np.arange(left, right + 1)
        else:
            target = rng.integers(
                left + cfg.min_distance_to_context_views,
                right + 1 - cfg.min_distance_to_context_views,
                size=cfg.num_target_views,
            )
        if self.circular:
            target = target % num_views
            right = right % num_views
        return np.array([left, right]), np.asarray(target)

    @property
    def num_context_views(self):
        return 2

    @property
    def num_target_views(self):
        return self.cfg.num_target_views


class ViewSamplerEvaluation:
    """Fixed context and target indices per scene from an index JSON
    (assets/evaluation_index_*.json, or `main generate-index`)."""

    def __init__(self, index_path: str | Path, num_context_views: int = 2):
        with open(index_path) as f:
            self.index = json.load(f)
        self._num_context_views = num_context_views

    def sample(self, scene: str, num_views: int, rng=None, global_step: int = 0):
        entry = self.index.get(scene)
        if entry is None:
            raise ValueError(f"No evaluation entry for scene {scene}")
        return np.asarray(entry["context"]), np.asarray(entry["target"])

    def scenes(self):
        return [k for k, v in self.index.items() if v is not None]

    @property
    def num_context_views(self):
        return self._num_context_views

    @property
    def num_target_views(self):
        return 1


@dataclass
class ArbitraryCfg:
    num_context_views: int = 2
    num_target_views: int = 1
    context_views: list | None = None
    target_views: list | None = None


class ViewSamplerArbitrary:
    """Random (or fixed) context and target views."""

    def __init__(self, cfg: ArbitraryCfg):
        self.cfg = cfg

    def sample(self, scene: str, num_views: int, rng: np.random.Generator, global_step: int = 0):
        if self.cfg.context_views is not None:
            context = np.asarray(self.cfg.context_views)
        else:
            context = rng.integers(num_views, size=self.cfg.num_context_views)
        if self.cfg.target_views is not None:
            target = np.asarray(self.cfg.target_views)
        else:
            target = rng.integers(num_views, size=self.cfg.num_target_views)
        return context, target

    @property
    def num_context_views(self):
        return self.cfg.num_context_views

    @property
    def num_target_views(self):
        return self.cfg.num_target_views


class ViewSamplerAll:
    """Every view as both context and target."""

    def sample(self, scene: str, num_views: int, rng=None, global_step: int = 0):
        idx = np.arange(num_views)
        return idx, idx

    @property
    def num_context_views(self):
        return 0

    @property
    def num_target_views(self):
        return 0


def get_view_sampler(name: str, stage: str = "train", **kwargs):
    if name == "bounded":
        return ViewSamplerBounded(BoundedCfg(**kwargs), stage=stage)
    if name == "evaluation":
        return ViewSamplerEvaluation(**kwargs)
    if name == "arbitrary":
        return ViewSamplerArbitrary(ArbitraryCfg(**kwargs))
    if name == "all":
        return ViewSamplerAll()
    raise ValueError(f"unknown view sampler {name}")
