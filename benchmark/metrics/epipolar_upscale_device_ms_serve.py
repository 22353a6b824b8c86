"""epipolar_upscale_device_ms.serve: device time a request of the ops launched
inside the program's span epipolar_4_upscale (the transposed convolution,
the two full-resolution 7 x 7 convolutions and the image's skip)."""

from benchmark.metrics import common


def read(run):
    return common.device_ms(run, "epipolar_4_upscale")
