"""Image layout helpers (hcat, vcat, border, label) on numpy HWC images.

Counterpart of transplat_tpu/visualization/layout.py.
"""

from __future__ import annotations

import numpy as np


def _pad_to(image: np.ndarray, h: int, w: int, value: float = 1.0) -> np.ndarray:
    ih, iw = image.shape[:2]
    out = np.full((h, w, *image.shape[2:]), value, image.dtype)
    r = (h - ih) // 2
    c = (w - iw) // 2
    out[r : r + ih, c : c + iw] = image
    return out


def _join(images, axis: int, gap: int, value: float) -> np.ndarray:
    parts = []
    for i, im in enumerate(images):
        if i:
            shape = list(im.shape)
            shape[axis] = gap
            parts.append(np.full(shape, value, images[0].dtype))
        parts.append(im)
    return np.concatenate(parts, axis=axis)


def hcat(*images: np.ndarray, gap: int = 8, value: float = 1.0) -> np.ndarray:
    h = max(im.shape[0] for im in images)
    return _join([_pad_to(im, h, im.shape[1], value) for im in images], 1, gap, value)


def vcat(*images: np.ndarray, gap: int = 8, value: float = 1.0) -> np.ndarray:
    w = max(im.shape[1] for im in images)
    return _join([_pad_to(im, im.shape[0], w, value) for im in images], 0, gap, value)


def add_border(image: np.ndarray, border: int = 8, value: float = 1.0) -> np.ndarray:
    h, w = image.shape[:2]
    out = np.full((h + 2 * border, w + 2 * border, *image.shape[2:]), value, image.dtype)
    out[border : border + h, border : border + w] = image
    return out


def add_label(image: np.ndarray, label: str, height: int = 24) -> np.ndarray:
    """A white banner with `label` in black above the image (OpenCV's text)."""
    import cv2

    h, w = image.shape[:2]
    banner_u8 = np.full((height, w, 3), 255, np.uint8)
    cv2.putText(banner_u8, label, (4, height - 7), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    img3 = image if image.ndim == 3 else np.repeat(image[..., None], 3, -1)
    return np.concatenate([banner_u8.astype(np.float32) / 255.0, img3], axis=0)
