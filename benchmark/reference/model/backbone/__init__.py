from .cnn import CNNEncoder
from .multiview import BackboneMultiview, normalize_images
from .transformer import MultiViewFeatureTransformer

__all__ = ["BackboneMultiview", "CNNEncoder", "MultiViewFeatureTransformer", "normalize_images"]
