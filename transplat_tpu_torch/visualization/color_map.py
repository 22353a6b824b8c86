"""Turbo colour map for depth and score images (matplotlib-free).

Counterpart of transplat_tpu/visualization/color_map.py, in numpy.
"""

from __future__ import annotations

import numpy as np

# Polynomial approximation of the Turbo colormap (public-domain coefficients).
_R = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396, 59.28637943])
_G = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857, 2.82956604])
_B = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912, 27.34824973])


def _poly(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    v = np.zeros_like(x)
    for i, ci in enumerate(c):
        v = v + ci * x**i
    return v


def apply_color_map(values: np.ndarray) -> np.ndarray:
    """values in [0, 1] -> (..., 3) turbo RGB."""
    x = np.clip(np.asarray(values, np.float32), 0.0, 1.0)
    return np.clip(np.stack([_poly(x, _R), _poly(x, _G), _poly(x, _B)], axis=-1), 0.0, 1.0)


def apply_color_map_to_image(image: np.ndarray, invert: bool = False) -> np.ndarray:
    """(h, w) scalar map, min-max normalized, -> (h, w, 3)."""
    lo, hi = image.min(), image.max()
    x = (image - lo) / (hi - lo + 1e-8)
    if invert:
        x = 1.0 - x
    return apply_color_map(x)
