"""Synthetic posed batches (numpy only), a copy of `synthetic_batch` from
transplat_tpu/dataset/loader.py so the port needs nothing of the JAX package."""

from __future__ import annotations

import numpy as np


def synthetic_batch(
    key: int = 0,
    batch_size: int = 1,
    num_context: int = 2,
    num_target: int = 2,
    image_shape: tuple[int, int] = (256, 256),
    near: float = 1.0,
    far: float = 100.0,
) -> dict:
    """Random posed batch for tests/benchmarks (no dataset required)."""
    rng = np.random.default_rng(key)
    h, w = image_shape

    def views(v):
        intr = np.tile(
            np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], np.float32),
            (batch_size, v, 1, 1),
        )
        extr = np.tile(np.eye(4, dtype=np.float32), (batch_size, v, 1, 1))
        for i in range(v):
            extr[:, i, 0, 3] = 0.25 * i + 0.05 * rng.standard_normal(batch_size)
            extr[:, i, 1, 3] = 0.02 * rng.standard_normal(batch_size)
        return {
            "image": rng.random((batch_size, v, h, w, 3), np.float32),
            "intrinsics": intr,
            "extrinsics": extr,
            "near": np.full((batch_size, v), near, np.float32),
            "far": np.full((batch_size, v), far, np.float32),
            "index": np.tile(np.arange(v), (batch_size, 1)),
        }

    return {
        "context": views(num_context),
        "target": views(num_target),
        "scene": [f"synthetic_{i}" for i in range(batch_size)],
    }
