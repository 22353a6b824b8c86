from .loader import DataLoader, MultiWorkerLoader, batch_to_device, golden_scene_batch, synthetic_batch
from .view_samplers import (
    ViewSamplerAll,
    ViewSamplerArbitrary,
    ViewSamplerBounded,
    ViewSamplerEvaluation,
    get_view_sampler,
)

__all__ = [
    "DataLoader",
    "MultiWorkerLoader",
    "batch_to_device",
    "golden_scene_batch",
    "synthetic_batch",
    "ViewSamplerAll",
    "ViewSamplerArbitrary",
    "ViewSamplerBounded",
    "ViewSamplerEvaluation",
    "get_view_sampler",
]
