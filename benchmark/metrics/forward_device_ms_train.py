"""forward_device_ms.train: device time a step of the ops launched inside the
program's own spans train.encoder, train.decoder and train.loss."""

from benchmark.metrics import common


def read(run):
    return common.device_ms(run, "train.encoder", "train.decoder", "train.loss")
