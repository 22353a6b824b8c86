"""The program's spans and counters: what a torch.profiler trace of it can
put down to each layer.

`span(name)` marks a block of the program as a `torch.profiler`
`record_function` range while a profiler is running, and is one shared
no-op context otherwise, so that an untraced run pays a flag check for it
(a bare `record_function` costs the host an order of magnitude more, with
no profiler running). The ranges land in the profiler's own trace, on the clock of the
device ops they launch, and are written out with it
(`torch.profiler.profile.export_chrome_trace`, `Benchmarker.trace`).
While a CUDA graph is captured in segments (`cut_at_spans`,
utils/graphs.py) a span opens no range: its opening and its closing each
end one segment and begin the next, and the replay opens the span around
the segments it held, so a traced replay puts every device op under the
span it has in an eager run.

The spans, by layer:

  * the encoder: each of its ten `model.encoder.STAGES`, around the stage on
    every forward (model/encoder.py, model/depth_predictor.py)
  * pixelSplat's encoder: `epipolar_1_backbone`, `epipolar_2_sample`,
    `epipolar_3_attention`, `epipolar_4_upscale`, `epipolar_5_depth`, then
    the shared `encoder_5_gaussian_adapter` (`model.encoder_epipolar.STAGES`)
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
  * `counters()["adapter.fused"]` / `counters()["adapter.plain"]`: the
    encoder forwards whose Gaussian adapter stage took the hand-written
    kernel / the plain PyTorch version (model/encoder.py)
  * `counters()["render.project.fused"]` / `counters()["render.project.plain"]`:
    the renders whose projection took the hand-written kernel
    (csrc/project.cu) / the plain chain (ops/rasterizer/api.py `render`)
  * `counters()["epipolar.rays"]`: the rays of pixelSplat's epipolar sampler
    (its low grid, every view); `counters()["epipolar.rays_on_image"]`: those
    whose segment [near, far] meets the other view's image
    (model/encoder_epipolar.py). The second is summed on the card
    (`count_on_device`): no forward waits for it, and `counters()` reads it
  * `counters()["encoder.graph.replay"]`: the TranSplat encoder's forwards
    that replayed its CUDA graphs; `["encoder.graph.eager"]`: those that ran
    eagerly, the forward that warmed up and captured a graph included;
    `["encoder.graph.captures"]`: the graphs' captures, one a signature
    (model/encoder.py, utils/graphs.py)
  * `kernels.launches`: the launches of each hand-written kernel

A forward that replays a graph runs no Python of its layers: the counts its
captured pass added (`adapter.fused`, `kernels.launches`) are taken back at
the capture and added again at every replay (utils/graphs.py).
"""

from __future__ import annotations

import contextlib
import threading

import torch

_OFF = contextlib.nullcontext()
_counters: dict[str, int] = {}
_device_counters: dict[str, torch.Tensor] = {}
_capture = threading.local()  # .cut: where span() reports while a graph is captured in segments


def span(name: str):
    """A `record_function(name)` range while a profiler runs (on this thread,
    or on autograd's for a backward it runs); a shared no-op context
    otherwise; inside `cut_at_spans`, the cut points of a capture."""
    cut = getattr(_capture, "cut", None)
    if cut is not None:
        return _CutSpan(cut, name)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


class _CutSpan:
    __slots__ = ("cut", "name")

    def __init__(self, cut, name: str):
        self.cut, self.name = cut, name

    def __enter__(self):
        self.cut(self.name, True)

    def __exit__(self, exc_type, *exc):
        if exc_type is None:  # a capture that raised is abandoned (utils/graphs.py)
            self.cut(self.name, False)


@contextlib.contextmanager
def cut_at_spans(cut):
    """Inside (on this thread), `span(name)` opens no range: it calls
    `cut(name, True)` where it opens and `cut(name, False)` where it closes."""
    _capture.cut = cut
    try:
        yield
    finally:
        _capture.cut = None


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name`."""
    _counters[name] = _counters.get(name, 0) + n


def count_on_device(name: str, n: torch.Tensor) -> None:
    """Add the 0-dim integer tensor `n` to the counter `name` where it lies
    (one addition on its device; no host read until `counters()`)."""
    held = _device_counters.get(name)
    _device_counters[name] = n.detach().to(torch.int64) if held is None else held + n.detach()


def counters() -> dict[str, int]:
    """A copy of every counter since the process began or the last reset
    (reads the counters summed on a device)."""
    out = dict(_counters)
    for name, t in _device_counters.items():
        out[name] = out.get(name, 0) + int(t)
    return out


@contextlib.contextmanager
def withheld(into: dict, counts: dict | None = None):
    """What is added inside to `counts` (default: the counters `count` adds
    to; e.g. `kernels.launches`) lands in `into` instead."""
    counts = _counters if counts is None else counts
    held = dict(counts)
    try:
        yield into
    finally:
        for name, n in counts.items():
            if n != held.get(name, 0):
                into[name] = n - held.get(name, 0)
        counts.clear()
        counts.update(held)


def reset_counters() -> None:
    _counters.clear()
    _device_counters.clear()
