"""The evaluator's video trajectories, frozen: a wobble about the first
context view and an interpolation from the first to the last.

Copied from transplat_tpu_torch/evaluation/evaluator.py `video_cameras` and
visualization/trajectory.py, so that the viewer's cameras stay the same
whatever the program later does with its own.
"""

from __future__ import annotations

import numpy as np


def _wobble(extrinsics: np.ndarray, radius: float, t: np.ndarray) -> np.ndarray:
    tf = np.broadcast_to(np.eye(4, dtype=np.float32), (t.shape[0], 4, 4)).copy()
    r = radius * t
    tf[:, 0, 3] = np.sin(2 * np.pi * t) * r
    tf[:, 1, 3] = -np.cos(2 * np.pi * t) * r
    return extrinsics[None] @ tf


def _so3_log(r: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-8:
        return np.zeros(3)
    w = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]) / (2.0 * np.sin(theta))
    return w * theta


def _so3_exp(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    if theta < 1e-8:
        return np.eye(3)
    k = w / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def _interpolate(initial: np.ndarray, final: np.ndarray, t: np.ndarray) -> np.ndarray:
    r0, p0, p1 = initial[:3, :3], initial[:3, 3], final[:3, 3]
    w = _so3_log(final[:3, :3] @ r0.T)
    out = []
    for ti in t:
        e = np.eye(4)
        e[:3, :3] = _so3_exp(w * ti) @ r0
        e[:3, 3] = (1 - ti) * p0 + ti * p1
        out.append(e)
    return np.stack(out)


def video_cameras(extrinsics: np.ndarray, intrinsics: np.ndarray, frames: int) -> tuple[np.ndarray, np.ndarray]:
    """(extrinsics (2 frames, 4, 4), intrinsics (2 frames, 3, 3)) float32 of
    one scene's context views (v, 4, 4), (v, 3, 3): `frames` of the wobble
    (radius a quarter of the context baseline) then `frames` of the
    interpolation from the first context view to the last."""
    t = np.linspace(0, 1, frames)
    delta = float(np.linalg.norm(extrinsics[0, :3, 3] - extrinsics[-1, :3, 3]) * 0.25 + 1e-3)
    wobble = _wobble(extrinsics[0], delta, t)
    interp = _interpolate(extrinsics[0], extrinsics[-1], t)
    k = (1 - t)[:, None, None] * intrinsics[0][None] + t[:, None, None] * intrinsics[-1][None]
    extr = np.concatenate([wobble, interp]).astype(np.float32)
    intr = np.concatenate([np.repeat(intrinsics[:1], frames, 0), k]).astype(np.float32)
    return extr, intr
