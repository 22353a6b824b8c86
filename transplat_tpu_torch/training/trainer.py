"""Training loop: data -> train step -> logging -> validation -> checkpoints.

Counterpart of transplat_tpu/training/trainer.py on one device. What the JAX
Trainer has and this one does not yet: its own data pipeline (`fit` needs a
`data_iter`; the chunk dataset and the view samplers are not ported), the
device mesh and `shard_batch`, loading pretrained / DAv2 / LPIPS weight files
(give a loaded LPIPS module to the constructor instead), and the validation
media (picture grid, orthographic projections, wobble video).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Iterator

import torch

from ..config import RootCfg
from ..dataset.loader import CONTEXT_KEYS, batch_to_device
from ..evaluation.metrics import compute_psnr
from ..loss.vgg import LPIPS
from ..model.decoder import decode_splatting
from .checkpointing import CheckpointManager
from .schedule import make_lr_schedule
from .step import TrainState, create_train_state, make_optimizer, make_train_step


class Trainer:
    def __init__(
        self,
        cfg: RootCfg,
        log_fn: Callable[[str], None] = print,
        device: str | torch.device = "cuda",
        lpips: LPIPS | None = None,
        log_every: int = 50,
    ):
        """`lpips`: a loaded (frozen) LPIPS module on `device`, or None to
        train without the perceptual term. `log_every`: steps between log
        lines and metric records."""
        ckpt = cfg.checkpointing
        if ckpt.pretrained_model or ckpt.dav2_weights or ckpt.lpips_weights:
            raise NotImplementedError(
                "checkpointing.pretrained_model / dav2_weights / lpips_weights: loading weight files "
                "(training/pretrained.py of the JAX package) is not ported yet"
            )
        self.cfg = cfg
        self.device = torch.device(device)
        self.log = log_fn
        self.log_every = log_every
        self.lpips = lpips
        self.global_step = 0

        schedule = make_lr_schedule(
            cfg.optimizer.lr,
            cfg.trainer.max_steps,
            cosine=cfg.optimizer.cosine_lr,
            warm_up_steps=cfg.optimizer.warm_up_steps,
        )
        self.optimizer = make_optimizer(schedule, cfg.optimizer.gradient_clip_val)
        self.image_shape = tuple(cfg.dataset.image_shape)
        self.step_fn = make_train_step(
            cfg.encoder, cfg.loss, cfg.decoder, self.optimizer, self.image_shape,
            deterministic_kernels=cfg.trainer.deterministic_kernels,
        )
        self.ckpt = CheckpointManager(ckpt.save_dir, ckpt.every_n_train_steps)
        # Beside the checkpoints' directory: outputs/metrics.jsonl for the default save_dir.
        self.metrics_path = Path(ckpt.save_dir).parent / "metrics.jsonl"
        self._dropout = torch.Generator(device=self.device)

    @torch.no_grad()
    def validate(self, state: TrainState, batch: dict) -> dict:
        """Render a validation batch in eval mode and return {"val_psnr"}: the
        mean PSNR over its target views. (The JAX Trainer also saves a context
        | target | prediction grid and 3D media; those wait for the port of
        visualization/ and utils/image_io.py.)"""
        views = batch_to_device(batch, self.device)
        ctx, tgt = views["context"], views["target"]
        gaussians = state.encoder(*(ctx[k] for k in CONTEXT_KEYS))
        color = decode_splatting(
            gaussians, tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"], self.image_shape, cfg=self.cfg.decoder
        ).color
        psnr = compute_psnr(tgt["image"].reshape(-1, *tgt["image"].shape[-3:]), color.reshape(-1, *color.shape[-3:]))
        return {"val_psnr": float(psnr.mean())}

    def _log_metrics(self, record: dict, path: str | Path | None = None) -> None:
        """Append-only JSONL metric log."""
        p = Path(path) if path is not None else self.metrics_path
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _step_generator(self) -> torch.Generator:
        """The dropout masks' generator for the step about to run. The JAX
        Trainer splits one key stream from PRNGKey(seed + 1) and starts it
        anew after a resume; here every step seeds from (seed + 1, step), so
        a resumed run draws the masks the uninterrupted run would have."""
        return self._dropout.manual_seed((self.cfg.trainer.seed + 1) * 1_000_003 + self.global_step)

    def fit(self, data_iter: Iterator[dict] | None = None, max_steps: int | None = None) -> TrainState:
        """Train on the batches of `data_iter` (numpy or tensor batches as the
        loaders make them) until `max_steps` or the iterator's end; returns
        the state. Resumes from `checkpointing.save_dir` when it holds a
        checkpoint, else warm-starts from `checkpointing.load`."""
        cfg = self.cfg
        max_steps = max_steps if max_steps is not None else cfg.trainer.max_steps
        if data_iter is None:
            raise NotImplementedError(
                f"fit() without data_iter would read training chunks under {cfg.dataset.roots}, but the chunk "
                "dataset and the view samplers (dataset/re10k.py, dataset/view_samplers.py of the JAX package) "
                "are not ported yet: pass an iterator of batches"
            )

        # Run-config snapshot, next to the run's checkpoints.
        snapshot = Path(cfg.checkpointing.save_dir) / "config.json"
        snapshot.parent.mkdir(parents=True, exist_ok=True)
        snapshot.write_text(json.dumps(dataclasses.asdict(cfg), default=str, indent=1))

        first = next(data_iter)
        state = create_train_state(cfg.encoder, self.optimizer, self.lpips, device=self.device, seed=cfg.trainer.seed)
        restored = self.ckpt.restore(state)
        if restored is None and cfg.checkpointing.load:
            # Warm start from another run's checkpoints when this run's directory is fresh.
            restored = CheckpointManager(cfg.checkpointing.load).restore(state)
        if restored is not None:
            state = restored
            self.global_step = state.step
            self.log(f"resumed from step {self.global_step}")

        v = cfg.trainer.val_check_interval
        val_interval = max(1, int(v if v > 1 else v * max_steps))
        for _ in range(max(0, cfg.trainer.num_sanity_val_steps)):
            metrics = self.validate(state, first)
            self.log(f"sanity validation: psnr={metrics['val_psnr']:.2f}")

        batch = first
        t_last = time.perf_counter()
        while self.global_step < max_steps:
            state, metrics = self.step_fn(state, batch_to_device(batch, self.device), self._step_generator())
            self.global_step += 1

            if self.global_step % self.log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}  # reads the values: waits for the device
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                self.log(
                    f"step {self.global_step}: loss={metrics['loss']:.4f} "
                    f"psnr={metrics.get('psnr', 0):.2f} ({dt / self.log_every:.3f}s/it)"
                )
                self._log_metrics({"step": self.global_step, "s_per_it": dt / self.log_every, **metrics})
            if self.global_step % val_interval == 0:
                val_metrics = self.validate(state, batch)
                self._log_metrics({"step": self.global_step, **val_metrics})
            self.ckpt.maybe_save(self.global_step, state)

            try:
                batch = next(data_iter)
            except StopIteration:
                break

        self.ckpt.save(self.global_step, state)
        return state
