"""Evaluation harness: render target views, score them, write the artifacts.

Counterpart of transplat_tpu/evaluation/evaluator.py: per scene PSNR / SSIM
(/ LPIPS when an LPIPS module is given) and the dropped-pair count, encoder
and decoder timed through the Benchmarker (timing skips the first
`eval_time_skip_steps` scenes), per-scene and averaged score JSONs. `run`
reads the test chunks through the evaluation index (`test.evaluation_index`)
one scene at a time, or any iterable of batches it is given. The options
of cfg.test: `stage_timing` (the encoder through the StagedEncoder, ten
stages in benchmark.json), `analyze` (analysis_per_scene.json and
analysis_avg.json, utils/analysis.py), `save_video` (wobble and
interpolation videos of 30 frames each), `save_ply` (the Gaussians as a
3DGS .ply), and `run(save_images=True)` the rendered targets as PNGs. A
scene is encoded once; its videos and PLY reuse that encoding.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from ..config import RootCfg
from ..dataset.loader import CONTEXT_KEYS, DataLoader, batch_to_device
from ..dataset.re10k import ChunkDataset
from ..dataset.view_samplers import ViewSamplerEvaluation
from ..loss.vgg import LPIPS
from ..model.decoder import decode_splatting
from ..model.encoder import EncoderTranSplat
from ..model.types import Gaussians
from ..utils.benchmarker import Benchmarker
from .metrics import compute_psnr, compute_ssim
from .staged import StagedEncoder

VIDEO_FRAMES = 30


def video_cameras(batch: dict, num_frames: int = VIDEO_FRAMES) -> dict:
    """{"wobble" | "interpolation": (extrinsics (T, 4, 4), intrinsics (T, 3, 3))}
    around the first scene's context views, as numpy float32: a wobble about
    the first view of radius a quarter of the context baseline, and the
    first to the last view."""
    from ..visualization.trajectory import generate_wobble, interpolate_extrinsics, interpolate_intrinsics

    ctx = batch["context"]
    extr = np.asarray(torch.as_tensor(ctx["extrinsics"][0]).cpu())
    intr0 = np.asarray(torch.as_tensor(ctx["intrinsics"][0]).cpu())
    t = np.linspace(0, 1, num_frames)
    delta = np.linalg.norm(extr[0, :3, 3] - extr[-1, :3, 3]) * 0.25 + 1e-3
    trajectories = {
        "wobble": (generate_wobble(extr[0], np.asarray(delta), t), np.repeat(intr0[:1], num_frames, 0)),
        "interpolation": (interpolate_extrinsics(extr[0], extr[-1], t), interpolate_intrinsics(intr0[0], intr0[-1], t)),
    }
    return {k: (np.asarray(e, np.float32), np.asarray(i, np.float32)) for k, (e, i) in trajectories.items()}


class Evaluator:
    def __init__(
        self,
        cfg: RootCfg,
        encoder: EncoderTranSplat,  # or EncoderEpipolar (model.build_encoder)
        lpips: LPIPS | None = None,
        device: str | torch.device = "cuda",
    ):
        """`encoder` (in eval mode) and `lpips` (or None: no LPIPS score) live on `device`."""
        self.cfg = cfg
        self.encoder = encoder
        self.lpips = lpips
        self.device = torch.device(device)
        self.image_shape = tuple(cfg.dataset.image_shape)
        self.benchmarker = Benchmarker(self.device)
        self.scores: dict[str, dict] = {}
        self.analysis_stats: dict[str, dict] = {}
        self.encoded: tuple[Gaussians, dict] | None = None  # the last scene's (gaussians, aux)
        # Stage-resolved timing (encoder_1 ... encoder_5) through the staged encoder.
        self._staged = StagedEncoder(encoder) if cfg.test.stage_timing else None

    def make_dataset(self, stage: str = "test") -> ChunkDataset:
        """The chunks of `stage` with the context and target views of the evaluation index."""
        index_path = self.cfg.test.evaluation_index
        if index_path is None:
            raise ValueError(
                "cfg.test.evaluation_index is not set: evaluation uses fixed "
                "context/target indices (reference assets/evaluation_index_*"
                ".json). Point it at an index JSON, or create one with "
                "`python -m transplat_tpu_torch.main generate-index`."
            )
        return ChunkDataset(self.cfg.dataset, stage, ViewSamplerEvaluation(index_path))

    @torch.no_grad()
    def encode(self, batch: dict) -> tuple[Gaussians, dict]:
        """The context views' Gaussians and the encoder's aux outputs (return_aux)."""
        ctx = batch_to_device(batch, self.device)["context"]
        return self.encoder(*(ctx[k] for k in CONTEXT_KEYS), return_aux=True)

    @torch.no_grad()
    def evaluate_batch(self, batch: dict) -> tuple[dict, np.ndarray]:
        """One scene: (scores, rendered colours (b, tv, h, w, 3) as numpy).
        The scene's encoding stays in `self.encoded` as (gaussians, aux)."""
        views = batch_to_device(batch, self.device)
        ctx, tgt = views["context"], views["target"]
        with self.benchmarker.time("encoder"):
            if self._staged is not None:
                gaussians, aux = self._staged.run(ctx, benchmarker=self.benchmarker)
            else:
                gaussians, aux = self.encoder(*(ctx[k] for k in CONTEXT_KEYS), return_aux=True)
        self.encoded = (gaussians, aux)
        tv = tgt["image"].shape[1]
        with self.benchmarker.time("decoder", num_calls=tv):
            out = decode_splatting(
                gaussians, tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"], self.image_shape,
                cfg=self.cfg.decoder,
            )
        flat_p = out.color.reshape(-1, *out.color.shape[-3:])
        flat_t = tgt["image"].reshape(-1, *tgt["image"].shape[-3:])
        result = {
            "psnr": compute_psnr(flat_t, flat_p).mean().item(),
            "ssim": compute_ssim(flat_t, flat_p).mean().item(),
            "render_overflow": int(out.overflow.sum()),
        }
        if self.lpips is not None:
            result["lpips"] = self.lpips(flat_p, flat_t).mean().item()
        if self.cfg.test.analyze:
            self.analysis_stats[batch["scene"][0]] = self._analyze(gaussians, aux, out.radii)
        return result, out.color.cpu().numpy()

    def _analyze(self, gaussians: Gaussians, aux: dict, radii: torch.Tensor) -> dict:
        """Per-scene workload analysis (the fork's research layer): Gaussian
        contribution and visibility from the rasterizer's radii, adjacent-depth
        redundancy, depth-PDF sharpness, feature-depth correlation
        (utils/analysis.py)."""
        from ..utils.analysis import (
            adjacent_gaussian_similarity,
            depth_pdf_stats,
            feature_depth_correlation,
            gaussian_contribution_stats,
        )

        opac = gaussians.opacities[:, None].expand(radii.shape)
        return {
            "contribution": gaussian_contribution_stats(radii, opac),
            "adjacent": adjacent_gaussian_similarity(aux["depths"], gaussians.opacities),
            "pdf": depth_pdf_stats(aux["pdf"]),
            "feature_depth": feature_depth_correlation(aux["features"], aux["depths"]),
        }

    def run(self, loader: Iterable[dict] | None = None, max_scenes: int | None = None,
            save_images: bool = False) -> dict:
        """Score every batch of `loader` (one scene each; default: the test
        chunks through the evaluation index), write each scene's artifacts
        (PNGs with `save_images`, videos and PLY as cfg.test asks) under
        cfg.test.output_path/<scene>/, then `finalize` there."""
        cfg = self.cfg
        out_dir = Path(cfg.test.output_path)
        out_dir.mkdir(parents=True, exist_ok=True)
        if loader is None:
            loader = DataLoader(self.make_dataset(), batch_size=1, drop_last=False)
        for i, batch in enumerate(loader):
            if max_scenes is not None and i >= max_scenes:
                break
            scores, color = self.evaluate_batch(batch)
            scene = batch["scene"][0]
            self.scores[scene] = scores
            if save_images:
                from ..utils.image_io import save_image

                for t in range(color.shape[1]):
                    save_image(color[0, t], out_dir / scene / f"color/{t:04d}.png")
            if cfg.test.save_video:
                self.render_video(batch, out_dir / scene, encoded=self.encoded)
            if cfg.test.save_ply:
                self.export_ply(batch, out_dir / scene / "gaussians.ply", encoded=self.encoded)
        self.finalize(out_dir)
        return self.scores

    @torch.no_grad()
    def render_video(self, batch: dict, out_dir, num_frames: int = VIDEO_FRAMES, encoded=None) -> dict:
        """Wobble and interpolation videos (`<name>.mp4`, `num_frames` frames
        each) around the context views, each trajectory decoded in one call
        of `num_frames` target views. Returns {name: frames (T, h, w, 3)}."""
        from ..utils.image_io import save_video

        gaussians = (encoded or self.encode(batch))[0]
        ctx = batch["context"]
        near = torch.full((1, num_frames), float(ctx["near"][0, 0]), dtype=torch.float32, device=self.device)
        far = torch.full((1, num_frames), float(ctx["far"][0, 0]), dtype=torch.float32, device=self.device)
        out_dir = Path(out_dir)
        videos = {}
        for name, (cams, intr) in video_cameras(batch, num_frames).items():
            color = decode_splatting(
                gaussians, torch.from_numpy(cams)[None].to(self.device), torch.from_numpy(intr)[None].to(self.device),
                near, far, self.image_shape, cfg=self.cfg.decoder,
            ).color
            frames = color[0].cpu().numpy()
            save_video(list(frames), out_dir / f"{name}.mp4")
            videos[name] = frames
        return videos

    @torch.no_grad()
    def export_ply(self, batch: dict, path, encoded=None) -> None:
        """The first scene's Gaussians as a 3DGS-standard .ply (visualization/ply_export.py)."""
        from ..visualization.ply_export import export_ply

        gaussians, aux = encoded or self.encode(batch)
        export_ply(
            gaussians.means[0].cpu().numpy(),
            aux["scales"][0].cpu().numpy(),
            aux["rotations"][0].cpu().numpy(),
            gaussians.harmonics[0].cpu().numpy(),
            gaussians.opacities[0].cpu().numpy(),
            path,
        )

    def finalize(self, out_dir: str | Path) -> None:
        """Write scores_per_scene.json, scores_all_avg.json, benchmark.json and,
        with test.analyze, analysis_per_scene.json and analysis_avg.json."""
        if not self.scores:
            return
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        keys = next(iter(self.scores.values())).keys()
        avg = {k: float(np.mean([s[k] for s in self.scores.values()])) for k in keys}
        with open(out_dir / "scores_per_scene.json", "w") as f:
            json.dump(self.scores, f, indent=2)
        with open(out_dir / "scores_all_avg.json", "w") as f:
            json.dump(avg, f, indent=2)
        if self.analysis_stats:
            per = self.analysis_stats
            first = next(iter(per.values()))
            analysis_avg = {
                g: {k: float(np.mean([per[s][g][k] for s in per])) for k in first[g] if isinstance(first[g][k], (int, float))}
                for g in first
            }
            with open(out_dir / "analysis_per_scene.json", "w") as f:
                json.dump(per, f, indent=2)
            with open(out_dir / "analysis_avg.json", "w") as f:
                json.dump(analysis_avg, f, indent=2)
            print("analysis averages:", json.dumps(analysis_avg, indent=1))
        skip = self.cfg.test.eval_time_skip_steps
        self.benchmarker.dump(out_dir / "benchmark.json", skip_first=skip)
        self.benchmarker.print_table(skip_first=skip)
        print("averaged scores:", avg)
