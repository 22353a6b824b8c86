"""epipolar_attention_device_ms.serve: device time a request of the ops launched
inside the program's spans epipolar_2_sample and epipolar_3_attention
(pixelSplat's epipolar sampler and the attention of each ray over its
samples)."""

from benchmark.metrics import common


def read(run):
    return common.device_ms(run, "epipolar_2_sample", "epipolar_3_attention")
