"""device_idle_share.train: the card's idle share of a step's time, in %."""

from benchmark.metrics import common


def read(run):
    return common.idle_share(run)
