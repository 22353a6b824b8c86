"""epipolar_backbone_device_ms.serve: device time a request of the ops launched
inside the program's span epipolar_1_backbone (pixelSplat's ResNet-50 and
DINO ViT-B/8, and the features' projection)."""

from benchmark.metrics import common


def read(run):
    return common.device_ms(run, "epipolar_1_backbone")
