"""deform_device_ms.serve: device time a request of the ops launched inside the
program's spans deform.scores and deform.vectors (K5, K7 and their wrappers)."""

from benchmark.metrics import common, program_spans


def read(run):
    return common.device_ms(run, *program_spans.SAMPLERS_FORWARD)
