"""Image and video files.

Counterpart of transplat_tpu/utils/image_io.py, on numpy arrays: PNGs
through Pillow, videos through OpenCV's `mp4v` writer (.mp4), as the JAX
package writes them. The card machine has both (Pillow 12.2.0 and
opencv-python-headless 4.13.0, whose wheel carries its own FFmpeg; there is
no `ffmpeg` program there).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image


def to_uint8(image: np.ndarray) -> np.ndarray:
    """(h, w, 3) float [0, 1] -> uint8."""
    return (np.clip(np.asarray(image), 0.0, 1.0) * 255.0).astype(np.uint8)


def save_image(image: np.ndarray, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(to_uint8(image)).save(path)


def load_image(path: str | Path) -> np.ndarray:
    """(h, w, 3) float32 in [0, 1]."""
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0


def save_video(frames: list[np.ndarray], path: str | Path, fps: int = 30) -> None:
    """Frames (h, w, 3) float [0, 1] -> an mp4 (`mp4v`) at `fps`."""
    import cv2

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"OpenCV cannot open an mp4v writer for {path}")
    for frame in frames:
        writer.write(cv2.cvtColor(to_uint8(frame), cv2.COLOR_RGB2BGR))
    writer.release()


def load_video(path: str | Path) -> np.ndarray:
    """Every frame of a video as (n, h, w, 3) uint8 RGB."""
    import cv2

    capture = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    capture.release()
    if not frames:
        raise ValueError(f"no frame could be read from {path}")
    return np.stack(frames)
