"""The "serve" kind: a request is a scene's context views and target cameras;
the program's `inference.render_novel_views` encodes and renders them, and
the colours come back to the host. The benchmark's spans for the traced
window: forward hooks around the program's encoder, and a span around the
render.
"""

from __future__ import annotations

import contextlib

import torch

from .. import tracing
from ..serving import FIELDS, Serving, to_device
from ..spec import Cell
from ..traffic import Scene


class Driver(Serving):
    encodes_per_unit = True

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        from transplat_tpu_torch import inference

        super().__init__(cell, seed, device)
        self._inference = inference
        # The requests arrive from the host.
        self.scenes = [Scene(to_device(s.context, "cpu"), to_device(s.targets, "cpu")) for s in self.scenes]
        self._capture = None
        self.encoder.register_forward_hook(self._hook)

    def _hook(self, module, args, out):
        if self._capture is not None:
            self._capture["gaussians"] = tuple(getattr(out, f)[0] for f in FIELDS)

    def run_unit(self, i: int, keep: bool) -> dict | None:
        k = int(self.order[i % len(self.order)])
        scene = self.scenes[k]
        self._capture = {"index": i, "scene": k} if keep else None
        colors = self._inference.render_novel_views(
            self.encoder, scene.context, scene.targets, self.image_shape, self.decoder_cfg, self.device
        ).cpu()
        captured, self._capture = self._capture, None
        if captured is not None:
            captured["colors"] = colors
        return captured

    def sample_scene(self, s: dict):
        scene = self.scenes[s["scene"]]
        return scene, scene.targets

    @contextlib.contextmanager
    def spans(self):
        inf = self._inference
        decode = inf.decode_splatting

        def render(*args, **kwargs):
            with tracing.record_function("render"):
                return decode(*args, **kwargs)

        inf.decode_splatting = render
        try:
            with tracing.module_span(self.encoder, "encoder"):
                yield
        finally:
            inf.decode_splatting = decode
