from .loader import synthetic_batch

__all__ = ["synthetic_batch"]
