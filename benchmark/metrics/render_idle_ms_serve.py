"""render_idle_ms.serve: the card's idle time a request put down to the
program's four render.* spans, in ms (`program_spans.idle_ms`)."""

from benchmark.metrics import program_spans


def read(run):
    return program_spans.idle_ms(run, program_spans.RENDER_STEPS)
