"""mfu.train: a step's FLOPs, counted on the reference, over its time in the
untraced window times the card's float32 peak, in %."""

from benchmark.metrics import common


def read(run):
    return common.mfu(run)
