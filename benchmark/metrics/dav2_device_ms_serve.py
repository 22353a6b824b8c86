"""dav2_device_ms.serve: device time a request of the ops launched inside the
program's span encoder_3_depth_anything (the frozen DAv2 prior)."""

from benchmark.metrics import common


def read(run):
    return common.device_ms(run, "encoder_3_depth_anything")
