"""device_idle_share.serve: the card's idle share of a request's time, in %."""

from benchmark.metrics import common


def read(run):
    return common.idle_share(run)
