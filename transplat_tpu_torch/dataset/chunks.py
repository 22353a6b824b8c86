"""Synthetic scenes in the RE10K chunk format, from a seed, for tests and
the tools (no dataset is fetched).

A chunk is a `torch.save`d list of scenes: {"key": str, "cameras": (n, 18)
float32 tensor [fx, fy, cx, cy, 0, 0, world-to-camera 3x4 row-major],
"images": [uint8 tensor of JPEG bytes, ...]}, as the RE10K converter writes
it. The camera pans (yaws) at a steady rate while it slides sideways, so
that the view overlap falls with the frame distance as
`main generate-index` needs; the frames are a smooth random panorama seen
through a window that moves with the pan. The JPEGs are written with the
library of the machine's JPEG route (`native.encode_jpeg_batch`), the one
that decodes them. `make_png_scene` packs PNG frames as the DTU converter
does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import native


def orbit_poses(num_frames: int, yaw_deg_per_frame: float = 0.3, slide_per_frame: float = 0.01, focal: float = 1.0):
    """(num_frames, 18) float32 pose rows of a camera that yaws about y and slides along x."""
    poses = np.zeros((num_frames, 18), np.float32)
    poses[:, 0] = poses[:, 1] = focal
    poses[:, 2] = poses[:, 3] = 0.5
    for f in range(num_frames):
        th = np.radians(yaw_deg_per_frame * f)
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
        c2w[0, 3] = slide_per_frame * f
        poses[f, 6:] = np.linalg.inv(c2w)[:3].reshape(-1)
    return poses


def panorama_frames(num_frames: int, hw: tuple[int, int], seed: int, pan_px_per_frame: int = 2) -> np.ndarray:
    """(num_frames, h, w, 3) uint8: windows onto one smooth random panorama."""
    h, w = hw
    rng = np.random.default_rng(seed)
    wide = w + pan_px_per_frame * num_frames
    coarse = (rng.random((1, h // 24 + 2, wide // 24 + 2, 3)) * 255).astype(np.uint8)
    pano = native.resize_bilinear_batch(coarse, (h, wide))[0]
    return np.stack([pano[:, pan_px_per_frame * f : pan_px_per_frame * f + w] for f in range(num_frames)])


def make_scene(key: str, num_frames: int, seed: int, hw: tuple[int, int] = (360, 640),
               yaw_deg_per_frame: float = 0.3, quality: int = 95, jpeg_route: str | None = None) -> dict:
    """One scene of the chunk format."""
    blobs = native.encode_jpeg_batch(panorama_frames(num_frames, hw, seed), quality, route=jpeg_route)
    return {
        "key": key,
        "cameras": torch.from_numpy(orbit_poses(num_frames, yaw_deg_per_frame)),
        "images": [torch.frombuffer(bytearray(b), dtype=torch.uint8) for b in blobs],
    }


def make_png_scene(key: str, num_frames: int, seed: int, hw: tuple[int, int] = (512, 640),
                   yaw_deg_per_frame: float = 3.0, focal: float = 1.2) -> dict:
    """One scene as scripts/convert_dtu.py packs a DTU scan: the raw bytes of
    PNG files (Pillow's encoder), pose rows, `url` and `timestamps`."""
    import io

    from PIL import Image

    def png(frame: np.ndarray) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="PNG")
        return buf.getvalue()

    frames = panorama_frames(num_frames, hw, seed, pan_px_per_frame=6)
    return {
        "url": "",
        "timestamps": torch.arange(num_frames, dtype=torch.int64),
        "cameras": torch.from_numpy(orbit_poses(num_frames, yaw_deg_per_frame, focal=focal)),
        "images": [torch.frombuffer(bytearray(png(f)), dtype=torch.uint8) for f in frames],
        "key": key,
    }


def write_chunk(path: str | Path, scenes: list[dict]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(scenes, path)
    return path
