"""backbone_device_ms.serve: device time a request of the ops launched inside
the program's span encoder_2_backbone (the CNN and the multi-view Swin)."""

from benchmark.metrics import common


def read(run):
    return common.device_ms(run, "encoder_2_backbone")
