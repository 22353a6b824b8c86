"""launches_per_request.serve: device ops launched from inside a traced request."""

from benchmark.metrics import common


def read(run):
    return common.launches(run)
