"""The one traffic generator: posed scenes and request orders from a mix's
parameters (`benchmark/traffic/<name>.json`) and the run's seed.

A scene is a set of context views (images in [0, 1], normalized intrinsics,
camera-to-world extrinsics in OpenCV axes, near, far) and the cameras the
mix asks for, with their images where the mix trains on them
(`target_images`). A view's image is a crop of the scene's canvas, shifted
with the camera. Every seed gives the same shapes and the same number of
scenes; only the pictures, the poses and the order change. Cameras are
drawn on the host with numpy, images on `device` with a torch.Generator in
a few batched calls.

Camera layouts:
  * "baseline": the context cameras on a line (RE10K's forward-moving
    video frames), targets between them with a little jitter;
  * "arc": the context cameras on an arc around an object, each looking
    at its centre (DTU's turntable rig), targets on the same arc between
    the outer context views.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch.nn import functional as F

TRAFFIC_DIR = Path(__file__).resolve().parent.parent / "traffic"

# Independent streams drawn from one seed.
STREAM_CAMERAS, STREAM_IMAGES, STREAM_ORDER = 1, 2, 3


def load(name: str) -> dict:
    """The parameters of the traffic mix `name`."""
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each stream of one run's seed."""
    return (int(seed) * 1_000_003 + stream) % (1 << 63)


@dataclass
class Scene:
    """One scene: `context` holds image (1, v, H, W, 3), intrinsics (1, v, 3, 3),
    extrinsics (1, v, 4, 4), near and far (1, v); `targets` the cameras the
    mix renders, as intrinsics (1, t, 3, 3), extrinsics, near, far (1, t)."""

    context: dict
    targets: dict


def _rotation(yaw: float, pitch: float) -> np.ndarray:
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return ry @ rx


def _pose(rot: np.ndarray, pos: np.ndarray) -> np.ndarray:
    e = np.eye(4)
    e[:3, :3] = rot
    e[:3, 3] = pos
    return e


def _look_at(pos: np.ndarray, centre: np.ndarray) -> np.ndarray:
    fwd = centre - pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    return _pose(np.stack([right, down, fwd], axis=1), pos)


def _cameras(cam: dict, rng: np.random.Generator, num_context: int, num_target: int):
    """(context extrinsics (v, 4, 4), target extrinsics (t, 4, 4), focal, the
    image shifts in [-1, 1] of the context views then the targets) for one scene."""
    lo, hi = cam["focal"]
    focal = rng.uniform(lo, hi)
    if cam["layout"] == "baseline":
        base = rng.uniform(*cam["baseline"])
        yaw0 = np.radians(rng.uniform(-cam["yaw_deg"], cam["yaw_deg"]))
        turn = np.radians(rng.uniform(-cam["turn_deg"], cam["turn_deg"]))
        pitch = np.radians(rng.uniform(-cam["pitch_deg"], cam["pitch_deg"]))
        direction = _rotation(yaw0, 0.0)[:, 0]

        def at(t: float, jitter: float = 0.0) -> np.ndarray:
            pos = t * base * direction + jitter * rng.standard_normal(3)
            return _pose(_rotation(yaw0 + t * turn, pitch), pos)

        ctx_t = np.linspace(0.0, 1.0, num_context)
        tgt_t = rng.uniform(0.0, 1.0, num_target)
        context = [at(t) for t in ctx_t]
        targets = [at(t, cam["target_jitter"] * base) for t in tgt_t]
        shifts = (2 * np.concatenate([ctx_t, tgt_t]) - 1) * base / max(cam["baseline"][1], 1e-6)
    elif cam["layout"] == "arc":
        radius = rng.uniform(*cam["radius"])
        step = np.radians(rng.uniform(*cam["step_deg"]))
        centre = np.array([0.0, 0.0, radius])
        start = np.radians(rng.uniform(-cam["start_deg"], cam["start_deg"]))
        angles = start + step * (np.arange(num_context) - 0.5 * (num_context - 1))

        def at(angle: float) -> np.ndarray:
            pos = centre + radius * np.array([np.sin(angle), 0.0, -np.cos(angle)])
            return _look_at(pos, centre)

        tgt_angles = rng.uniform(angles[0], angles[-1], num_target)
        context = [at(a) for a in angles]
        targets = [at(a) for a in tgt_angles]
        shifts = (np.concatenate([angles, tgt_angles]) - start) / max(step * max(num_context - 1, 1) / 2, 1e-6)
    else:
        raise ValueError(f"unknown camera layout {cam['layout']!r}")
    targets = np.stack(targets) if targets else np.zeros((0, 4, 4))
    return np.stack(context), targets, focal, np.asarray(shifts, np.float64)


def _textures(images: dict, gen: torch.Generator, count: int, shape, device) -> torch.Tensor:
    """(count, 3, Hc, Wc) smooth colour canvases: seeded noise at a few
    resolutions, upsampled and summed with the mix's weights."""
    h, w = shape
    margin = images["margin"]
    hc, wc = h + 2 * margin, w + 2 * margin
    canvas = torch.zeros((count, 3, hc, wc), device=device)
    for res, weight in zip(images["octaves"], images["weights"]):
        grid = torch.rand((count, 3, res, res), generator=gen, device=device)
        canvas += weight * F.interpolate(grid, size=(hc, wc), mode="bicubic", align_corners=False)
    return canvas.clamp_(0.0, 1.0)


def make_scenes(traffic: dict, config: dict, seed: int, device, count: int | None = None) -> list[Scene]:
    """`count` (default: the mix's `scenes`) scenes of the mix on `device`."""
    count = traffic["scenes"] if count is None else count
    num_context = config["encoder"]["num_context_views"]
    num_target = traffic["target_views"]
    h, w = config["image_shape"]
    near, far = config["dataset"]["near"], config["dataset"]["far"]
    rng = np.random.default_rng(stream_seed(seed, STREAM_CAMERAS))
    cams = [_cameras(traffic["cameras"], rng, num_context, num_target) for _ in range(count)]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, STREAM_IMAGES))
    canvas = _textures(traffic["images"], gen, count, (h, w), device)
    margin = traffic["images"]["margin"]
    scenes = []
    for k, (ctx_e, tgt_e, focal, shifts) in enumerate(cams):
        crops = []
        for s in shifts:
            dx = int(round(margin + s * margin))
            crops.append(canvas[k, :, margin : margin + h, dx : dx + w])
        images = torch.stack(crops).permute(0, 2, 3, 1)[None].contiguous()

        def intr(n: int) -> torch.Tensor:
            k_ = torch.tensor([[focal, 0.0, 0.5], [0.0, focal, 0.5], [0.0, 0.0, 1.0]], dtype=torch.float32)
            return k_.expand(1, n, 3, 3).contiguous().to(device)

        def views(extr: np.ndarray) -> dict:
            n = extr.shape[0]
            return {
                "intrinsics": intr(n),
                "extrinsics": torch.as_tensor(extr, dtype=torch.float32)[None].to(device),
                "near": torch.full((1, n), near, dtype=torch.float32, device=device),
                "far": torch.full((1, n), far, dtype=torch.float32, device=device),
            }

        targets = views(tgt_e)
        if traffic.get("target_images"):
            targets["image"] = images[:, num_context:].contiguous()
        scenes.append(Scene(context={"image": images[:, :num_context].contiguous(), **views(ctx_e)}, targets=targets))
    return scenes


def request_order(traffic: dict, seed: int) -> np.ndarray:
    """A seeded permutation of the scenes: request i uses scene order[i % len(order)],
    so consecutive requests never share a scene."""
    rng = np.random.default_rng(stream_seed(seed, STREAM_ORDER))
    return rng.permutation(traffic["scenes"])
