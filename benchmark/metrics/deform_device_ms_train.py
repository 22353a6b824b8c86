"""deform_device_ms.train: device time a step of the ops launched inside the
program's spans deform.scores, deform.vectors and, on autograd's thread,
deform.scores_bwd and deform.vectors_bwd (K5-K8 and their wrappers)."""

from benchmark.metrics import common, program_spans


def read(run):
    return common.device_ms(run, *program_spans.SAMPLERS_FORWARD, *program_spans.SAMPLERS_BACKWARD)
