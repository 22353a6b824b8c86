"""tile_pairs_per_view.serve: the (tile, Gaussian) pairs of the tile lists K1
built a rendered view, from the program's counters render.pairs and
render.views over every render of the process."""

from benchmark.metrics import program_spans


def read(run):
    return program_spans.tile_pairs_per_view(run)
