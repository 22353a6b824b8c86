"""render_device_ms.serve: device time a request of the ops launched inside the
harness's span around the program's decode_splatting."""

from benchmark.metrics import common


def read(run):
    return common.device_ms(run, "render")
