"""Host-side example and batch structures (numpy, channel-last).

Own copy of transplat_tpu/dataset/types.py:
  views = {image (v, h, w, 3) f32, intrinsics (v, 3, 3), extrinsics (v, 4, 4),
           near (v,), far (v,), index (v,)}
  example = {context: views, target: views, scene: str}
Batched variants stack a leading batch axis; `batch_to_device` (loader.py)
moves a batch's views to the card as float32 tensors.
"""

from __future__ import annotations

from typing import TypedDict

import numpy as np


class Views(TypedDict):
    image: np.ndarray
    intrinsics: np.ndarray
    extrinsics: np.ndarray
    near: np.ndarray
    far: np.ndarray
    index: np.ndarray


class Example(TypedDict):
    context: Views
    target: Views
    scene: str
