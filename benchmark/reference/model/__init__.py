from .types import Gaussians

__all__ = ["Gaussians"]
