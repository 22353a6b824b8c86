"""Dataset shims: rescale and crop, x-reflection augmentation, patch alignment.

Own copy of transplat_tpu/dataset/shims.py in NHWC numpy. The LANCZOS
rescale goes through the native resize (transplat_tpu_torch/native), which
equals Pillow's bit for bit; there is no Pillow path (the JAX package falls
back to one).
"""

from __future__ import annotations

import numpy as np

from .. import native


def rescale_batch(images: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """LANCZOS resize of (v, h, w, 3) float images in [0, 1]."""
    u8 = (images * 255.0).clip(0, 255).astype(np.uint8)
    return native.resize_lanczos_batch(u8, shape).astype(np.float32) / 255.0


def center_crop(images: np.ndarray, intrinsics: np.ndarray, shape: tuple[int, int]):
    """images (v, h, w, 3); intrinsics (v, 3, 3) normalized."""
    h_in, w_in = images.shape[1:3]
    h_out, w_out = shape
    row = (h_in - h_out) // 2
    col = (w_in - w_out) // 2
    images = images[:, row : row + h_out, col : col + w_out]
    intrinsics = intrinsics.copy()
    intrinsics[:, 0, 0] *= w_in / w_out
    intrinsics[:, 1, 1] *= h_in / h_out
    return images, intrinsics


def rescale_and_crop(images: np.ndarray, intrinsics: np.ndarray, shape: tuple[int, int]):
    h_in, w_in = images.shape[1:3]
    h_out, w_out = shape
    if h_out > h_in or w_out > w_in:
        raise ValueError(f"cannot crop {h_in}x{w_in} images to a larger {h_out}x{w_out}")
    scale = max(h_out / h_in, w_out / w_in)
    h_scaled = round(h_in * scale)
    w_scaled = round(w_in * scale)
    images = rescale_batch(images, (h_scaled, w_scaled))
    return center_crop(images, intrinsics, shape)


def apply_crop_shim(example: dict, shape: tuple[int, int]) -> dict:
    out = dict(example)
    for key in ("context", "target"):
        views = dict(example[key])
        views["image"], views["intrinsics"] = rescale_and_crop(views["image"], views["intrinsics"], shape)
        out[key] = views
    return out


def _reflect_views(views: dict) -> dict:
    reflect = np.eye(4, dtype=np.float32)
    reflect[0, 0] = -1.0
    return {
        **views,
        "image": views["image"][:, :, ::-1].copy(),
        "extrinsics": reflect @ views["extrinsics"] @ reflect,
    }


def apply_augmentation_shim(example: dict, rng: np.random.Generator) -> dict:
    """Horizontal reflection of images and extrinsics, with probability 1/2."""
    if rng.random() < 0.5:
        return example
    return {
        **example,
        "context": _reflect_views(example["context"]),
        "target": _reflect_views(example["target"]),
    }


def apply_patch_shim(batch: dict, patch_size: int) -> dict:
    """Crop batched views to multiples of patch_size."""
    out = dict(batch)
    for key in ("context", "target"):
        views = dict(batch[key])
        h, w = views["image"].shape[-3:-1]
        h_new = (h // patch_size) * patch_size
        w_new = (w // patch_size) * patch_size
        if (h_new, w_new) == (h, w):
            out[key] = views
            continue
        row = (h - h_new) // 2
        col = (w - w_new) // 2
        views["image"] = views["image"][..., row : row + h_new, col : col + w_new, :]
        intr = views["intrinsics"].copy()
        intr[..., 0, 0] *= w / w_new
        intr[..., 1, 1] *= h / h_new
        views["intrinsics"] = intr
        out[key] = views
    return out
