"""What the serving kinds share ("serve" and "view", `kinds/serve.py` and
`kinds/view.py`): the program's encoder from the seeded weights, the
scenes, the frozen reference, the comparison with it and the work counted
on it; and the helpers every driver uses (precision, synchronize, free).

Requests arrive from the host: a serving request's context images and
cameras are host tensors that the program moves to the card itself.
"""

from __future__ import annotations

import contextlib
import gc

import numpy as np
import torch

from .driver import Driver
from .spec import Cell, build_dataclass
from .traffic import Scene, make_scenes, request_order
from .weights import load_parameters, seeded_parameters

FIELDS = ("means", "covariances", "harmonics", "opacities")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double().to(a.device)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-300))


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 for float32 matrix products and convolutions on or off inside."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_encoder(config: dict, device, weights: dict | None = None):
    """The frozen reference encoder of `config`, in eval mode; on the meta
    device without `weights`."""
    from benchmark.reference.model.encoder import EncoderCfg, EncoderTranSplat

    cfg = build_dataclass(EncoderCfg, config["encoder"])
    dev = "meta" if weights is None else device
    with torch.device(dev):
        encoder = EncoderTranSplat(cfg, device=dev)
    if weights is not None:
        load_parameters(encoder, weights)
    return encoder.eval()


def seeded_weights(config: dict, seed: int, device) -> dict:
    return seeded_parameters(reference_encoder(config, device), seed, device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def to_device(views: dict, device) -> dict:
    return {k: v.to(device) for k, v in views.items()}


class Serving(Driver):
    """What both serving drivers share: the program's encoder from the
    seeded weights, the scenes, the reference and the comparison."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        from transplat_tpu_torch.model.decoder import DecoderCfg
        from transplat_tpu_torch.model.encoder import EncoderCfg, EncoderTranSplat

        self.config, self.traffic, self.seed, self.device = cell.config, cell.traffic, seed, device
        self.image_shape = tuple(self.config["image_shape"])
        self.decoder_cfg = build_dataclass(DecoderCfg, self.config["decoder"])
        with torch.device(device):
            self.encoder = EncoderTranSplat(build_dataclass(EncoderCfg, self.config["encoder"]), device=device)
        load_parameters(self.encoder, seeded_weights(self.config, seed, device))
        self.encoder.eval()
        self.scenes = make_scenes(self.traffic, self.config, seed, device)
        self.order = request_order(self.traffic, seed)
        self._reference = None

    def end_to_end(self, latencies: list[float], window_s: float, peak: int) -> dict[str, float]:
        """Requests completed per second over the whole window, and the 95th
        percentile of every request's time from send to result."""
        return {
            "requests_per_s": len(latencies) / window_s,
            "request_ms_p95": float(np.percentile(np.asarray(latencies) * 1e3, 95)),
        }

    def warm(self) -> None:
        super().warm()
        sync(self.device)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.encoder = None
        free(self.device)

    def reference(self):
        if self._reference is None:
            self._reference = reference_encoder(self.config, self.device, seeded_weights(self.config, self.seed, self.device))
        return self._reference

    def ref_gaussians(self, scene: Scene):
        ctx = to_device(scene.context, self.device)
        with torch.no_grad():
            g = self.reference()(ctx["image"], ctx["intrinsics"], ctx["extrinsics"], ctx["near"], ctx["far"])
        return tuple(getattr(g, f)[0] for f in FIELDS)

    def ref_colors(self, gaussians, cams: dict):
        from benchmark.reference.render import render_views

        bg = torch.tensor(self.config["decoder"]["background_color"], dtype=torch.float32, device=self.device)
        cams = to_device(cams, self.device)
        with torch.no_grad():
            return render_views(gaussians, cams["extrinsics"][0], cams["intrinsics"][0], cams["near"][0], self.image_shape, bg)

    def compare(self, samples: list[dict], control: bool = False) -> dict[str, float]:
        """The worst over `samples` of the relative L2 gaps of the program's
        Gaussians (the worst field) and colours from the reference's. With
        `control`, the reference's own Gaussians and render, computed with
        TF32 on, stand in the program's place. No sample reads NaN."""
        if not samples:
            return {"gaussians_rel": float("nan"), "color_rel": float("nan")}
        worst = {"gaussians_rel": 0.0, "color_rel": 0.0}
        for s in samples:
            scene, cams = self.sample_scene(s)
            with precision(False):
                ref = self.ref_gaussians(scene)
                ref_colors, _ = self.ref_colors(ref, cams)
            if not control:
                prog, prog_colors = s["gaussians"], s["colors"]
            else:
                with precision(True):
                    prog = self.ref_gaussians(scene)
                    prog_colors, _ = self.ref_colors(prog, cams)
            worst["gaussians_rel"] = max(worst["gaussians_rel"], max(rel_l2(p, r) for p, r in zip(prog, ref)))
            worst["color_rel"] = max(worst["color_rel"], rel_l2(prog_colors.reshape(ref_colors.shape), ref_colors))
        return worst

    def counts(self, traced: list[dict]) -> dict[str, float]:
        """The work of a traced unit, on the reference: its FLOPs (encoder and
        render) and the render's least bytes and operations."""
        from benchmark.metrics import counting
        from benchmark.reference.model import uv_transformer

        kept, nbytes = 0, 0
        for s in traced:
            scene, cams = self.sample_scene(s)
            g = s["gaussians"]
            with precision(False):
                _, k = self.ref_colors(g, cams)
            kept += k
            nbytes += counting.render_bytes(g[0].shape[0], g[2].shape[-1], cams["extrinsics"].shape[1], self.image_shape)
        render_ops = counting.render_ops(kept) / len(traced)
        out = {"render_ops_per_unit": render_ops, "render_bytes_per_unit": nbytes / len(traced)}
        if self.encodes_per_unit:
            scene, _ = self.sample_scene(traced[0])
            ctx = to_device(scene.context, self.device)
            out["flops_per_unit"] = counting.encoder_flops(self.reference(), uv_transformer, ctx) + render_ops
        return out
