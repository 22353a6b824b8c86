"""The "serve_epipolar" kind: the "serve" kind's requests (kinds/serve.py)
served by pixelSplat's encoder (transplat_tpu_torch/model/encoder_epipolar.py
`EncoderEpipolar`, through `inference.render_novel_views`), held to the
plain pixelSplat of benchmark/reference/model/epipolar.py.

A request encodes 2 context views into 3 Gaussians a pixel and renders the
target views; the colours come back to the host. The benchmark's spans in
the traced window are the "serve" kind's: the harness's `encoder` hooks and
`render` wrapper, beside the program's own `epipolar_*` spans.

The comparison: a pixel's three Gaussians sit at its three most probable
depth buckets, and which buckets those are jumps where two probabilities
tie. So the program's picks (what its `depths` stage returns) are
compared with the reference's first: `pick_mismatch_share` is the share of
pixels whose ordered picks differ although the reference's four largest
probabilities lie at least the mix's `pick_margin` apart (a fault, not a
tie); `gaussians_rel` is the worst field's relative L2 gap over the
Gaussians of the pixels whose picks agree; `color_rel` the colours' gap, as
the "serve" kind takes it. `tie_share` (read, not compared) is the share of
pixels whose picks differ at all.
"""

from __future__ import annotations

import torch

from .. import serving
from ..serving import FIELDS, precision, rel_l2, to_device
from ..spec import Cell, build_dataclass
from ..traffic import Scene, make_scenes, request_order
from ..weights import load_parameters, seeded_parameters
from .serve import Driver as Serve


def reference_encoder(config: dict, device, weights: dict | None = None):
    """The frozen plain pixelSplat of `config`, in eval mode; on the meta
    device without `weights`."""
    from benchmark.reference.model.epipolar import EncoderEpipolar, EncoderEpipolarCfg

    cfg = build_dataclass(EncoderEpipolarCfg, config["encoder"])
    dev = "meta" if weights is None else device
    with torch.device(dev):
        encoder = EncoderEpipolar(cfg, device=dev)
    if weights is not None:
        load_parameters(encoder, weights)
    return encoder.eval()


def seeded_weights(config: dict, seed: int, device) -> dict:
    return seeded_parameters(reference_encoder(config, device), seed, device)


class Driver(Serve):
    encodes_per_unit = True

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        from transplat_tpu_torch import inference
        from transplat_tpu_torch.model import build_encoder
        from transplat_tpu_torch.model.decoder import DecoderCfg
        from transplat_tpu_torch.model.encoder_epipolar import EncoderEpipolarCfg

        self.config, self.traffic, self.seed, self.device = cell.config, cell.traffic, seed, device
        self.image_shape = tuple(self.config["image_shape"])
        self.decoder_cfg = build_dataclass(DecoderCfg, self.config["decoder"])
        self.encoder_cfg = build_dataclass(EncoderEpipolarCfg, self.config["encoder"])
        with torch.device(device):
            self.encoder = build_encoder(self.encoder_cfg, device=device)
        load_parameters(self.encoder, seeded_weights(self.config, seed, device))
        self.encoder.eval()
        self._inference = inference
        # The requests arrive from the host.
        scenes = make_scenes(self.traffic, self.config, seed, device)
        self.scenes = [Scene(to_device(s.context, "cpu"), to_device(s.targets, "cpu")) for s in scenes]
        self.order = request_order(self.traffic, seed)
        self._reference = None
        self._capture = None
        self.encoder.register_forward_hook(self._hook)
        depths = self.encoder.depths

        def capture_picks(*args, **kwargs):
            out = depths(*args, **kwargs)
            if self._capture is not None:
                self._capture["picks"] = out[2]
            return out

        self.encoder.depths = capture_picks

    def reference(self):
        if self._reference is None:
            self._reference = reference_encoder(self.config, self.device,
                                                seeded_weights(self.config, self.seed, self.device))
        return self._reference

    def ref_encode(self, scene: Scene):
        """The reference's Gaussians (fields of the one batch entry), its picks
        (v H W, k) and its k + 1 largest bucket probabilities (v H W, k + 1)."""
        ctx = to_device(scene.context, self.device)
        k = self.encoder_cfg.gaussians_per_pixel
        with torch.no_grad():
            g, picks, top = self.reference()(ctx["image"], ctx["intrinsics"], ctx["extrinsics"], ctx["near"],
                                              ctx["far"], return_picks=True)
        return tuple(getattr(g, f)[0] for f in FIELDS), picks[0].reshape(-1, k), top[0].reshape(-1, k + 1)

    def compare(self, samples: list[dict], control: bool = False) -> dict[str, float]:
        """Over `samples`, the worst of: `pick_mismatch_share` (picks that
        differ away from a tie), `gaussians_rel` (over the pixels whose picks
        agree), `color_rel`; and `tie_share`. With `control`, the reference
        computed with TF32 on stands in the program's place. No sample reads NaN."""
        names = ("gaussians_rel", "color_rel", "pick_mismatch_share", "tie_share")
        if not samples:
            return dict.fromkeys(names, float("nan"))
        k = self.encoder_cfg.gaussians_per_pixel
        margin = self.traffic["check"]["pick_margin"]
        worst = dict.fromkeys(names, 0.0)
        for s in samples:
            scene, cams = self.sample_scene(s)
            with precision(False):
                ref, ref_picks, top = self.ref_encode(scene)
                ref_colors, _ = self.ref_colors(ref, cams)
            if control:
                with precision(True):
                    prog, prog_picks, _ = self.ref_encode(scene)
                    prog_colors, _ = self.ref_colors(prog, cams)
            else:
                prog, prog_colors = s["gaussians"], s["colors"]
                prog_picks = s["picks"][0].reshape(-1, k)
            differ = (prog_picks != ref_picks).any(-1)
            apart = (top[:, :-1] - top[:, 1:]).min(-1).values >= margin
            agree = ~differ
            worst["pick_mismatch_share"] = max(worst["pick_mismatch_share"], float((differ & apart).float().mean()))
            worst["tie_share"] = max(worst["tie_share"], float(differ.float().mean()))
            keep = agree.repeat_interleave(k)  # the pixel's k Gaussians, (view, pixel, sample) order
            worst["gaussians_rel"] = max(worst["gaussians_rel"], max(rel_l2(p[keep], r[keep]) for p, r in zip(prog, ref)))
            worst["color_rel"] = max(worst["color_rel"], rel_l2(prog_colors.reshape(ref_colors.shape), ref_colors))
        return worst

    def counts(self, traced: list[dict]) -> dict[str, float]:
        """The work of a traced unit, on the reference: its FLOPs (the encoder
        by FlopCounterMode plus the epipolar samples' bilinear reads, and the
        render) and the render's least bytes and operations."""
        from benchmark.metrics import counting
        from benchmark.metrics.epipolar_counting import encoder_flops

        kept, nbytes = 0, 0
        for s in traced:
            scene, cams = self.sample_scene(s)
            g = s["gaussians"]
            with precision(False):
                _, n = self.ref_colors(g, cams)
            kept += n
            nbytes += counting.render_bytes(g[0].shape[0], g[2].shape[-1], cams["extrinsics"].shape[1], self.image_shape)
        render_ops = counting.render_ops(kept) / len(traced)
        scene, _ = self.sample_scene(traced[0])
        with precision(False):
            flops = encoder_flops(self.reference(), to_device(scene.context, self.device))
        return {"render_ops_per_unit": render_ops, "render_bytes_per_unit": nbytes / len(traced),
                "flops_per_unit": flops + render_ops}

    def release(self) -> None:
        self.encoder = None
        serving.free(self.device)
