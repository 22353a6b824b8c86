"""encoder_graph_share.serve: the share of the TranSplat encoder's forwards
that replayed its CUDA graphs, in %, from the program's counters
encoder.graph.replay and encoder.graph.eager over every forward of the
process (the warm-up's capture included). A program without those counters
gives nothing to read."""


def read(run):
    if not run.trace.ops:
        return None
    try:
        from transplat_tpu_torch.utils.trace import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    replay, eager = c.get("encoder.graph.replay", 0), c.get("encoder.graph.eager", 0)
    return 100.0 * replay / (replay + eager) if replay + eager else None
