"""RE10K / ACID / DTU chunk reader.

Own copy of transplat_tpu/dataset/re10k.py: iterates `.torch` chunk files
(lists of scenes, each with JPEG bytes and 18-float poses), samples context
and target views, decodes them and applies the shims. Everything it yields is
numpy NHWC; torch only loads the chunks on the host.

An example is built in two halves. `ChunkDataset._sample_example` makes every
random draw in the JAX package's order (views, then the reflection) and
every skip (too few frames, FOV, shape, baseline; the shape is read from the
JPEG headers), and keeps the views' JPEG bytes. `finish_example` decodes,
reflects, rescales and crops. The host route ("libjpeg") finishes an example
where it is sampled, in a forked loader worker too; the card route
("nvjpeg", transplat_tpu_torch/native) finishes it in the process that owns
the card (`iter_examples(decode=False)` in the workers).

Where the JAX reader waits forever, this one raises: a full pass over chunks
that yields no example is an error (every scene skipped, or no chunk read).
`DatasetCfg` is in config.py, field for field the JAX one.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from .. import native
from ..config import DatasetCfg
from .shims import _reflect_views, apply_crop_shim
from .types import Example

__all__ = ["ChunkDataset", "DatasetCfg", "convert_poses", "finish_example"]


def convert_poses(poses: np.ndarray):
    """18-float rows -> (camera-to-world 4x4, normalized K 3x3)."""
    b = poses.shape[0]
    intrinsics = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    fx, fy, cx, cy = poses[:, 0], poses[:, 1], poses[:, 2], poses[:, 3]
    intrinsics[:, 0, 0] = fx
    intrinsics[:, 1, 1] = fy
    intrinsics[:, 0, 2] = cx
    intrinsics[:, 1, 2] = cy
    w2c = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    w2c[:, :3] = poses[:, 6:].reshape(b, 3, 4)
    return np.linalg.inv(w2c), intrinsics


def _decode_images(blobs: list[bytes], jpeg_route: str | None = None) -> np.ndarray:
    """JPEG bytes -> (n, h, w, 3) float32 in [0, 1]."""
    return native.decode_jpeg_batch(blobs, route=jpeg_route).astype(np.float32) / 255.0


def _fov_deg(intrinsics: np.ndarray) -> np.ndarray:
    fx = intrinsics[:, 0, 0]
    fy = intrinsics[:, 1, 1]
    fov_x = 2.0 * np.arctan(0.5 / fx)
    fov_y = 2.0 * np.arctan(0.5 / fy)
    return np.degrees(np.stack([fov_x, fov_y], -1))


def finish_example(pending: dict, image_shape: tuple[int, int], jpeg_route: str | None = None) -> Example:
    """Decode a sampled example's JPEGs, reflect it if its draw said so, and
    rescale and crop it to `image_shape`."""
    example = {"scene": pending["scene"]}
    for key in ("context", "target"):
        views = dict(pending[key])
        views["image"] = _decode_images(views["image"], jpeg_route)
        example[key] = _reflect_views(views) if pending["reflect"] else views
    return apply_crop_shim(example, tuple(image_shape))


class ChunkDataset:
    """Iterable over examples from .torch chunks.

    stage: train | val | test (val reads the test split). For several
    processes pass shard_id / num_shards to stripe the chunks; each shard
    draws from seed + shard_id. `jpeg_route`: the decoder (default
    `native.jpeg_route()`)."""

    def __init__(
        self,
        cfg: DatasetCfg,
        stage: str,
        view_sampler,
        seed: int = 1234,
        shard_id: int = 0,
        num_shards: int = 1,
        jpeg_route: str | None = None,
    ):
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        self.jpeg_route = jpeg_route
        self.rng = np.random.default_rng(seed + shard_id)
        self.chunks: list[Path] = []
        # RE10K ships train/ and test/ only: the val stage reads the test
        # chunks (held out from the optimizer) with val-stage sampling.
        data_stage = "test" if stage == "val" else stage
        for root in cfg.roots:
            stage_dir = Path(root) / data_stage
            if stage_dir.exists():
                self.chunks.extend(sorted(stage_dir.glob("*.torch")))
        self.chunks = self.chunks[shard_id::num_shards]

    def __iter__(self) -> Iterator[Example]:
        return self.iter_examples()

    def iter_examples(self, global_step_fn=None, decode: bool = True) -> Iterator[dict]:
        """One pass over the chunks. `global_step_fn` gives the curriculum's
        step; with `decode=False` the examples stay sampled but not decoded,
        for `finish_example` in another process. Raises RuntimeError if the
        chunks yield no example."""
        chunks = list(self.chunks)
        if self.stage == "train":
            self.rng.shuffle(chunks)

        yielded = 0
        for chunk_path in chunks:
            try:
                chunk = torch.load(chunk_path, weights_only=False)
            except (RuntimeError, EOFError):
                continue

            if self.cfg.overfit_to_scene is not None:
                item = [x for x in chunk if x["key"] == self.cfg.overfit_to_scene]
                chunk = item * len(chunk)

            if self.stage == "train":
                order = self.rng.permutation(len(chunk))
                chunk = [chunk[i] for i in order]

            tps = self.cfg.test_times_per_scene
            for run_idx in range(tps * len(chunk)):
                raw = chunk[run_idx // tps]
                step = 0 if global_step_fn is None else global_step_fn()
                pending = self._sample_example(raw, run_idx % tps, step)
                if pending is not None:
                    yielded += 1
                    yield finish_example(pending, self.cfg.image_shape, self.jpeg_route) if decode else pending
        if chunks and not yielded:
            raise RuntimeError(
                f"a full pass over {len(chunks)} {self.stage} chunk(s) under {self.cfg.roots} yielded no example: "
                "every scene was skipped (fewer frames than the view sampler needs, a field of view over "
                f"{self.cfg.max_fov} degrees, frames other than {self.cfg.expected_shape}, a baseline under "
                f"{self.cfg.baseline_epsilon}, no evaluation index entry) or no chunk could be read"
            )

    def _sample_example(self, raw, run_sub_idx: int, global_step: int) -> dict | None:
        """The views of one scene with their JPEG bytes, or None if it is skipped."""
        poses = np.asarray(raw["cameras"], dtype=np.float32)
        extrinsics, intrinsics = convert_poses(poses)
        scene = raw["key"]
        if self.cfg.test_times_per_scene > 1:
            scene = f"{scene}_{run_sub_idx:02d}"

        try:
            ctx_idx, tgt_idx = self.view_sampler.sample(scene, len(poses), self.rng, global_step)
        except ValueError:
            return None

        if (_fov_deg(intrinsics) > self.cfg.max_fov).any():
            return None

        ctx_blobs = [np.asarray(raw["images"][i], dtype=np.uint8).tobytes() for i in ctx_idx]
        tgt_blobs = [np.asarray(raw["images"][i], dtype=np.uint8).tobytes() for i in tgt_idx]

        if self.cfg.skip_bad_shape and self.cfg.expected_shape is not None:
            exp = tuple(self.cfg.expected_shape)
            if any(native.jpeg_shape(b) != exp for b in ctx_blobs + tgt_blobs):
                return None

        scale = 1.0
        if len(ctx_idx) == 2 and self.cfg.make_baseline_1:
            a = extrinsics[ctx_idx[0], :3, 3]
            b = extrinsics[ctx_idx[1], :3, 3]
            scale = float(np.linalg.norm(a - b))
            if scale < self.cfg.baseline_epsilon:
                return None
            extrinsics = extrinsics.copy()
            extrinsics[:, :3, 3] /= scale

        nf_scale = scale if self.cfg.baseline_scale_bounds else 1.0

        def views(idx, blobs):
            n = len(idx)
            return {
                "extrinsics": extrinsics[idx],
                "intrinsics": intrinsics[idx],
                "image": blobs,
                "near": np.full((n,), self.cfg.near / nf_scale, np.float32),
                "far": np.full((n,), self.cfg.far / nf_scale, np.float32),
                "index": np.asarray(idx),
            }

        # The augmentation's draw (apply_augmentation_shim: reflect unless < 0.5).
        reflect = self.stage == "train" and self.cfg.augment and not self.rng.random() < 0.5
        return {
            "context": views(ctx_idx, ctx_blobs),
            "target": views(tgt_idx, tgt_blobs),
            "scene": scene,
            "reflect": reflect,
        }
