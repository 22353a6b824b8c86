"""The program's spans and counters: what a torch.profiler trace of it can
put down to each layer.

`span(name)` marks a block of the program as a `torch.profiler`
`record_function` range while a profiler is running, and is one shared
no-op context otherwise, so that an untraced run pays a flag check for it
(a bare `record_function` costs the host an order of magnitude more, with
no profiler running). The ranges land in the profiler's own trace, on the clock of the
device ops they launch, and are written out with it
(`torch.profiler.profile.export_chrome_trace`, `Benchmarker.trace`).

The spans, by layer:

  * the encoder: each of its ten `model.encoder.STAGES`, around the stage on
    every forward (model/encoder.py, model/depth_predictor.py)
  * the render: `render.project` (projection into the cameras),
    `render.sort` (the depth sort), `render.bin` (K1's tile lists, with the
    host read of their length), `render.composite` (K3's forward)
    (ops/rasterizer/api.py)
  * the deformable samplers: `deform.scores` and `deform.vectors` around
    their forwards (K5, K7), `deform.scores_bwd` and `deform.vectors_bwd`
    inside their backwards (K6, K8), which run on autograd's thread
    (ops/deform.py)
  * the training step: `train.encoder`, `.decoder`, `.loss`, `.backward`,
    `.all_reduce` and `.optimizer` (training/step.py)

What the program counts, always on:

  * `counters()["render.pairs"]`: the (tile, Gaussian) pairs of the tile
    lists K1 built, over every render; `counters()["render.views"]`: the
    views rendered (ops/rasterizer/api.py `rasterize`, the tile path)
  * `kernels.launches`: the launches of each hand-written kernel
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_counters: dict[str, int] = {}


def span(name: str):
    """A `record_function(name)` range while a profiler runs (on this thread,
    or on autograd's for a backward it runs); a shared no-op context
    otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name`."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of every counter since the process began or the last reset."""
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()
