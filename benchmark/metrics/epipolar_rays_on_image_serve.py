"""epipolar_rays_on_image.serve: the share of pixelSplat's epipolar rays whose
segment [near, far] meets the other view's image, in %, from the program's
counters epipolar.rays_on_image and epipolar.rays over every forward of the
process. A program without those counters gives nothing to read."""


def read(run):
    if not run.trace.ops:
        return None
    try:
        from transplat_tpu_torch.utils.trace import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    rays = c.get("epipolar.rays", 0)
    return 100.0 * c.get("epipolar.rays_on_image", 0) / rays if rays else None
