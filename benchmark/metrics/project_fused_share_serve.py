"""project_fused_share.serve: the share of the renders whose projection took
the program's hand-written kernel, in %, from the program's counters
render.project.fused and render.project.plain over every render of the
process. A program without those counters gives nothing to read."""


def read(run):
    if not run.trace.ops:
        return None
    try:
        from transplat_tpu_torch.utils.trace import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    fused, plain = c.get("render.project.fused", 0), c.get("render.project.plain", 0)
    return 100.0 * fused / (fused + plain) if fused + plain else None
