from .loader import DataLoader, batch_to_device, golden_scene_batch, synthetic_batch

__all__ = ["DataLoader", "batch_to_device", "golden_scene_batch", "synthetic_batch"]
