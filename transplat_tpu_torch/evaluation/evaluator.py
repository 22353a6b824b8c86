"""Evaluation harness: render target views, score them, dump the scores.

Counterpart of transplat_tpu/evaluation/evaluator.py: per scene PSNR / SSIM
(/ LPIPS when an LPIPS module is given) and the dropped-pair count, encoder
and decoder timed through the Benchmarker (timing skips the first
`eval_time_skip_steps` scenes), per-scene and averaged score JSONs. `run`
reads the test chunks through the evaluation index (`test.evaluation_index`)
one scene at a time, or any iterable of batches it is given. What the JAX
Evaluator has and this one does not yet: the staged encoder timing, the
workload analysis, saved images, videos and the PLY export.
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
from ..utils.benchmarker import Benchmarker
from .metrics import compute_psnr, compute_ssim


class Evaluator:
    def __init__(
        self,
        cfg: RootCfg,
        encoder: EncoderTranSplat,
        lpips: LPIPS | None = None,
        device: str | torch.device = "cuda",
    ):
        """`encoder` (in eval mode) and `lpips` (or None: no LPIPS score) live on `device`."""
        if cfg.test.stage_timing or cfg.test.analyze or cfg.test.save_video or cfg.test.save_ply:
            raise NotImplementedError(
                "test.stage_timing / analyze / save_video / save_ply: the staged encoder, the analysis layer, "
                "videos and the PLY export are not ported yet"
            )
        self.cfg = cfg
        self.encoder = encoder
        self.lpips = lpips
        self.device = torch.device(device)
        self.image_shape = tuple(cfg.dataset.image_shape)
        self.benchmarker = Benchmarker(self.device)
        self.scores: dict[str, dict] = {}

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
    def evaluate_batch(self, batch: dict) -> tuple[dict, np.ndarray]:
        """One scene: (scores, rendered colours (b, tv, h, w, 3) as numpy)."""
        views = batch_to_device(batch, self.device)
        ctx, tgt = views["context"], views["target"]
        with self.benchmarker.time("encoder"):
            gaussians = self.encoder(*(ctx[k] for k in CONTEXT_KEYS))
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
        return result, out.color.cpu().numpy()

    def run(self, loader: Iterable[dict] | None = None, max_scenes: int | None = None) -> dict:
        """Score every batch of `loader` (one scene each; default: the test
        chunks through the evaluation index), then `finalize` into
        cfg.test.output_path."""
        out_dir = Path(self.cfg.test.output_path)
        out_dir.mkdir(parents=True, exist_ok=True)
        if loader is None:
            loader = DataLoader(self.make_dataset(), batch_size=1, drop_last=False)
        for i, batch in enumerate(loader):
            if max_scenes is not None and i >= max_scenes:
                break
            scores, _ = self.evaluate_batch(batch)
            self.scores[batch["scene"][0]] = scores
        self.finalize(out_dir)
        return self.scores

    def finalize(self, out_dir: str | Path) -> None:
        """Write scores_per_scene.json, scores_all_avg.json and benchmark.json."""
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
        skip = self.cfg.test.eval_time_skip_steps
        self.benchmarker.dump(out_dir / "benchmark.json", skip_first=skip)
        self.benchmarker.print_table(skip_first=skip)
        print("averaged scores:", avg)
