"""backward_device_ms.train: device time a step of the ops launched inside the
program's own span train.backward (cuDNN and cuBLAS gradients, K2, K4, K6, K8)."""

from benchmark.metrics import common


def read(run):
    return common.device_ms(run, "train.backward")
