"""epipolar_idle_ms.serve: the card's idle time a request put down to the
program's five epipolar_* stage spans of pixelSplat's encoder, in ms
(`program_spans.idle_ms`)."""

from benchmark.metrics import program_spans

EPIPOLAR_STAGES = (
    "epipolar_1_backbone", "epipolar_2_sample", "epipolar_3_attention", "epipolar_4_upscale", "epipolar_5_depth",
)


def read(run):
    return program_spans.idle_ms(run, EPIPOLAR_STAGES)
