"""The "view" kind: set-up encodes the mix's scenes once with the program's
encoder and keeps their Gaussians on the card; a request renders one frame
of a scene's video trajectory through the program's `decode_splatting`,
never of the scene of the request before.
"""

from __future__ import annotations

import contextlib

import torch

from .. import tracing
from ..serving import FIELDS, Serving, free
from ..spec import Cell
from ..trajectory import video_cameras


class Driver(Serving):
    encodes_per_unit = False

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        from transplat_tpu_torch.model.decoder import decode_splatting

        super().__init__(cell, seed, device)
        self._decode = decode_splatting
        frames = self.traffic["frames"]
        self.gaussians, self.cameras = [], []
        with torch.no_grad():
            for scene in self.scenes:
                ctx = scene.context
                self.gaussians.append(self.encoder(ctx["image"], ctx["intrinsics"], ctx["extrinsics"], ctx["near"], ctx["far"]))
                extr, intr = video_cameras(ctx["extrinsics"][0].cpu().numpy(), ctx["intrinsics"][0].cpu().numpy(), frames)
                n = extr.shape[0]
                self.cameras.append({
                    "extrinsics": torch.as_tensor(extr, device=device)[:, None],
                    "intrinsics": torch.as_tensor(intr, device=device)[:, None],
                    "near": ctx["near"][0, :1].expand(n)[:, None].contiguous(),
                    "far": ctx["far"][0, :1].expand(n)[:, None].contiguous(),
                })
        self.frames = 2 * frames
        self.encoder = None  # a viewer holds the Gaussians, not the encoder
        free(device)

    def _frame(self, i: int) -> tuple[int, int]:
        n = len(self.order)
        return int(self.order[i % n]), (i // n) % self.frames

    def run_unit(self, i: int, keep: bool) -> dict | None:
        k, f = self._frame(i)
        cams = self.cameras[k]
        out = self._decode(
            self.gaussians[k], cams["extrinsics"][f : f + 1], cams["intrinsics"][f : f + 1], cams["near"][f : f + 1],
            cams["far"][f : f + 1], self.image_shape, cfg=self.decoder_cfg,
        )
        colors = out.color.cpu()
        if not keep:
            return None
        return {"index": i, "scene": k, "frame": f, "colors": colors,
                "gaussians": tuple(getattr(self.gaussians[k], n)[0] for n in FIELDS)}

    def sample_scene(self, s: dict):
        f = s["frame"]
        cams = {k: v[f : f + 1].transpose(0, 1) for k, v in self.cameras[s["scene"]].items()}
        return self.scenes[s["scene"]], cams

    @contextlib.contextmanager
    def spans(self):
        decode = self._decode

        def render(*args, **kwargs):
            with tracing.record_function("render"):
                return decode(*args, **kwargs)

        self._decode = render
        try:
            yield
        finally:
            self._decode = decode

    def release(self) -> None:
        self.gaussians = None
        super().release()
