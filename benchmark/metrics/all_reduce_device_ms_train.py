"""all_reduce_device_ms.train: device time a step of the ops launched inside
the program's span train.all_reduce (training/step.py: the gradients' and
the metrics' all-reduce over the dp group), on rank 0, in ms. The NCCL
kernel's time includes its wait for the slowest rank, so this is the
exchange's exposed cost. A step without a mesh opens no such span."""

from benchmark.metrics import common


def read(run):
    return common.device_ms(run, "train.all_reduce")
