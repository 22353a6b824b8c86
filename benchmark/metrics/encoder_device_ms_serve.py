"""encoder_device_ms.serve: device time a request of the ops launched inside
the encoder's span (the harness's forward hooks on the program's encoder)."""

from benchmark.metrics import common


def read(run):
    return common.device_ms(run, "encoder")
