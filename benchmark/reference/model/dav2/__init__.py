from .dpt import DAV2_CONFIGS, DepthAnythingV2

__all__ = ["DAV2_CONFIGS", "DepthAnythingV2"]
