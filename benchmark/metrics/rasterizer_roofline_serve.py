"""rasterizer_roofline.serve: the render's least time over its device time, in %."""

from benchmark.metrics import common


def read(run):
    return common.render_roofline(run)
