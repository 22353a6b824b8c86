"""Decoder-facing Gaussian container (counterpart of transplat_tpu/model/types.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Gaussians(NamedTuple):
    means: torch.Tensor  # (b, g, 3)
    covariances: torch.Tensor  # (b, g, 3, 3)
    harmonics: torch.Tensor  # (b, g, 3, d_sh)
    opacities: torch.Tensor  # (b, g)
