"""optimizer_device_ms.train: device time a step of the ops launched inside the
program's own span train.optimizer (the global-norm clip and Adam)."""

from benchmark.metrics import common


def read(run):
    return common.device_ms(run, "train.optimizer")
