"""launches_per_step.train: device ops launched from inside a traced step."""

from benchmark.metrics import common


def read(run):
    return common.launches(run)
