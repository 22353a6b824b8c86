"""unet_device_ms.serve: device time a request of the ops launched inside the
program's spans encoder_4c_cost_volume_unet and encoder_4e_depth_refine_unet
(the two U-Nets)."""

from benchmark.metrics import common


def read(run):
    return common.device_ms(run, "encoder_4c_cost_volume_unet", "encoder_4e_depth_refine_unet")
