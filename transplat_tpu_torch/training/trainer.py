"""Training loop: data -> train step -> logging -> validation -> checkpoints.

Counterpart of transplat_tpu/training/trainer.py on one device, in one
process (shard 0 of 1). With no `data_iter`, `fit` reads the training chunks
(`<root>/train/*.torch`) through the bounded view sampler, in
`trainer.num_workers` forked workers or a prefetch thread, and validates on a
held-out stream read from `<root>/test/*.torch` when there is one. The
weight files of `checkpointing` load as in the JAX Trainer: the
`pretrained_model` / `dav2_weights` trees merge over the initial parameters,
and `lpips_weights` (or a Lightning tree's embedded LPIPS) puts the
perceptual term into the loss. What the JAX Trainer has and this one does
not yet: the device mesh and `shard_batch`, and the validation media
(picture grid, orthographic projections, wobble video).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from .. import native
from ..config import RootCfg
from ..dataset.loader import CONTEXT_KEYS, DataLoader, MultiWorkerLoader, batch_to_device
from ..dataset.re10k import ChunkDataset, finish_example
from ..dataset.view_samplers import ViewSamplerBounded
from ..evaluation.metrics import compute_psnr
from ..loss.vgg import LPIPS, init_lpips
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
        train without the perceptual term (`checkpointing.lpips_weights`, when
        set, loads one in its place). `log_every`: steps between log lines and
        metric records."""
        ckpt = cfg.checkpointing
        self.cfg = cfg
        self.device = torch.device(device)
        self.log = log_fn
        self.log_every = log_every
        if ckpt.lpips_weights:
            lpips = init_lpips(np.load(ckpt.lpips_weights, allow_pickle=True).item(), self.device)
            self.log(f"loaded LPIPS weights from {ckpt.lpips_weights}")
        self.lpips = lpips
        self.global_step = 0
        self._shared_step = None  # the curriculum's step as forked loader workers read it

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

    def make_dataset(self, stage: str = "train", seed_offset: int = 0, shard_id: int = 0, num_shards: int = 1,
                     jpeg_route: str | None = None) -> ChunkDataset:
        """The chunks of `stage` (val reads the test split) through the bounded view sampler."""
        sampler = ViewSamplerBounded(
            self.cfg.view_sampler, stage=stage, cameras_are_circular=self.cfg.dataset.cameras_are_circular
        )
        return ChunkDataset(
            self.cfg.dataset, stage, sampler, seed=self.cfg.trainer.seed + seed_offset,
            shard_id=shard_id, num_shards=num_shards, jpeg_route=jpeg_route,
        )

    def train_batches(self) -> Iterator[dict]:
        """Endless training batches from the chunks. The curriculum reads the
        live global step: through a shared multiprocessing.Value in forked
        workers (`trainer.num_workers` > 0), directly in the prefetch thread."""
        import multiprocessing as mp

        cfg = self.cfg
        probe = self.make_dataset("train")
        if not probe.chunks:
            raise FileNotFoundError(
                f"no training chunks found under {cfg.dataset.roots} (expected <root>/train/*.torch in the RE10K "
                "chunk format)"
            )
        route = native.jpeg_route()  # decided here, before any worker forks
        nw = cfg.trainer.num_workers
        self.log(f"data: {len(probe.chunks)} training chunk(s) under {cfg.dataset.roots}, JPEG route {route}, "
                 f"{nw} worker process(es)")
        if nw <= 0:
            dataset = self.make_dataset("train", jpeg_route=route)

            def epochs():
                while True:
                    yield from dataset.iter_examples(lambda: self.global_step)

            return iter(DataLoader(epochs(), cfg.trainer.batch_size))

        self._shared_step = mp.get_context("fork").Value("l", self.global_step)
        shared = self._shared_step
        in_workers = native.route_runs_in_workers(route)

        def make_worker_iter(worker_id: int):
            ds = self.make_dataset("train", seed_offset=worker_id, shard_id=worker_id, num_shards=nw, jpeg_route=route)
            if not ds.chunks:  # more workers than chunks: this one has nothing to read
                return iter(())

            def epochs():
                while True:
                    yield from ds.iter_examples(lambda: shared.value, decode=in_workers)

            return epochs()

        finish = None
        if not in_workers:
            def finish(pending):
                return finish_example(pending, cfg.dataset.image_shape, route)
        return iter(MultiWorkerLoader(make_worker_iter, nw, cfg.trainer.batch_size, finish=finish))

    def val_batches(self) -> Iterator[dict] | None:
        """Endless one-example batches of the held-out `val` stage (the test
        split), or None when there are no held-out chunks."""
        dataset = self.make_dataset("val")
        if not dataset.chunks:
            return None

        def epochs():
            while True:
                yield from dataset.iter_examples(lambda: self.global_step)

        return iter(DataLoader(epochs(), 1))

    def fit(self, data_iter: Iterator[dict] | None = None, max_steps: int | None = None) -> TrainState:
        """Train on the batches of `data_iter` (numpy or tensor batches as the
        loaders make them; default: the training chunks) until `max_steps` or
        the iterator's end; returns the state. Validates on the held-out
        stream when test chunks exist, else on the current training batch.
        Resumes from `checkpointing.save_dir` when it holds a checkpoint, else
        warm-starts from `checkpointing.load`."""
        cfg = self.cfg
        max_steps = max_steps if max_steps is not None else cfg.trainer.max_steps
        self._shared_step = None
        own_iter = data_iter is None
        if own_iter:
            data_iter = self.train_batches()
        val_iter = self.val_batches()
        try:
            return self._fit(data_iter, val_iter, max_steps)
        finally:  # stop the loaders this call started (worker processes, prefetch threads)
            for it in ((data_iter,) if own_iter else ()) + ((val_iter,) if val_iter is not None else ()):
                it.close()

    def _fit(self, data_iter: Iterator[dict], val_iter: Iterator[dict] | None, max_steps: int) -> TrainState:
        cfg = self.cfg

        # Run-config snapshot, next to the run's checkpoints.
        snapshot = Path(cfg.checkpointing.save_dir) / "config.json"
        snapshot.parent.mkdir(parents=True, exist_ok=True)
        snapshot.write_text(json.dumps(dataclasses.asdict(cfg), default=str, indent=1))

        first = next(data_iter)
        state = create_train_state(cfg.encoder, self.optimizer, self.lpips, device=self.device, seed=cfg.trainer.seed,
                                   ckpt_cfg=cfg.checkpointing)
        if cfg.checkpointing.pretrained_model or cfg.checkpointing.dav2_weights:
            self.log(f"loaded pretrained weights: model={cfg.checkpointing.pretrained_model} "
                     f"dav2={cfg.checkpointing.dav2_weights}")
        restored = self.ckpt.restore(state)
        if restored is None and cfg.checkpointing.load:
            # Warm start from another run's checkpoints when this run's directory is fresh.
            restored = CheckpointManager(cfg.checkpointing.load).restore(state)
        if restored is not None:
            state = restored
            self.global_step = state.step
            if self._shared_step is not None:
                self._shared_step.value = self.global_step
            self.log(f"resumed from step {self.global_step}")

        def validate(fallback: dict) -> dict:
            batch = next(val_iter) if val_iter is not None else fallback
            return {**self.validate(state, batch), "val_scenes": list(batch["scene"])}

        v = cfg.trainer.val_check_interval
        val_interval = max(1, int(v if v > 1 else v * max_steps))
        for _ in range(max(0, cfg.trainer.num_sanity_val_steps)):
            metrics = validate(first)
            self.log(f"sanity validation: psnr={metrics['val_psnr']:.2f} scenes={metrics['val_scenes']}")

        batch = first
        t_last = time.perf_counter()
        while self.global_step < max_steps:
            state, metrics = self.step_fn(state, batch_to_device(batch, self.device), self._step_generator())
            self.global_step += 1
            if self._shared_step is not None:
                self._shared_step.value = self.global_step

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
                self._log_metrics({"step": self.global_step, **validate(batch)})
            self.ckpt.maybe_save(self.global_step, state)

            try:
                batch = next(data_iter)
            except StopIteration:
                break

        self.ckpt.save(self.global_step, state)
        return state
