from .losses import LossCfg, compute_losses, depth_smoothness_loss, mse_loss
from .vgg import LPIPS, VGG16Features

__all__ = ["LPIPS", "LossCfg", "VGG16Features", "compute_losses", "depth_smoothness_loss", "mse_loss"]
