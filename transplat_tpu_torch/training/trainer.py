"""Training loop: data -> train step -> logging -> validation -> checkpoints.

Counterpart of transplat_tpu/training/trainer.py. With no `data_iter`,
`fit` reads the training chunks (`<root>/train/*.torch`) through the
bounded view sampler, in `trainer.num_workers` forked workers or a prefetch
thread, and validates on a held-out stream read from `<root>/test/*.torch` when there is one. The
weight files of `checkpointing` load as in the JAX Trainer: the
`pretrained_model` / `dav2_weights` trees merge over the initial parameters,
and `lpips_weights` (or a Lightning tree's embedded LPIPS) puts the
perceptual term into the loss. Each validation writes the JAX Trainer's
media: a context | target | prediction grid and, with
`trainer.val_save_media`, the orthographic projections of the first
example's Gaussians with the context cameras drawn on them and a 14-frame
wobble video. They go to `<save_dir>/../local` (`outputs/local` for the
default `save_dir`, where the JAX Trainer writes them), beside
`metrics.jsonl`.

With a `mesh` (parallel/mesh.py; one process per rank, `main train --dp
--sp` under torchrun) every rank runs `fit`: the chunks are striped by dp
rank, each rank's batch is `trainer.batch_size` examples, and the step is
the dp x sp step of training/step.py. The ranks of one sp group must train
on the same batch, and two loaders of one shard need not yield it in one
order (the workers share a queue; the prefetch thread reads the live step),
so sp rank 0 of each dp group alone loads and broadcasts each batch over
its sp group (`_sp_shared`). Rank 0 alone writes checkpoints, `metrics.jsonl`,
`config.json` and the validation media (the port's CheckpointManager has no
multi-process save, which Orbax gives the JAX Trainer); the other ranks wait
at a barrier where it writes. A restored state is broadcast from rank 0.
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
from ..model.types import Gaussians
from ..parallel.mesh import Mesh, replicated
from ..utils.image_io import save_image, save_video
from ..visualization.layout import add_label, hcat, vcat
from ..visualization.validation_3d import axis_looks, draw_cameras, render_orthographic, validation_wobble
from .checkpointing import CheckpointManager
from .schedule import make_lr_schedule
from .step import TrainState, create_train_state, make_optimizer, make_train_step


def dropout_seed(seed: int, step: int, dp_rank: int = 0) -> int:
    """The dropout masks' seed of a step: from (seed + 1, step, dp_rank). The
    ranks of one dp group draw the same masks (they compute one encoder
    forward and keep different slices of its Gaussians); dp groups draw
    their own. dp rank 0 draws what a one-process run draws. (The CPU
    generator keeps the seed's low 32 bits only: the dp rank moves them by
    1_000_000_007 a rank, which no run of fewer steps reaches.)"""
    return (seed + 1) * 1_000_003 + step + dp_rank * 1_000_000_007


class Trainer:
    def __init__(
        self,
        cfg: RootCfg,
        mesh: Mesh | None = None,
        log_fn: Callable[[str], None] = print,
        device: str | torch.device = "cuda",
        lpips: LPIPS | None = None,
        log_every: int = 50,
    ):
        """`mesh`: this rank's dp x sp mesh (its device replaces `device`), or
        None for one process. `lpips`: a loaded (frozen) LPIPS module on the
        device, or None to train without the perceptual term
        (`checkpointing.lpips_weights`, when set, loads one in its place).
        `log_every`: steps between log lines and metric records."""
        ckpt = cfg.checkpointing
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.writer = mesh is None or mesh.is_writer
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
            deterministic_kernels=cfg.trainer.deterministic_kernels, mesh=mesh,
        )
        self.ckpt = CheckpointManager(ckpt.save_dir, ckpt.every_n_train_steps)
        # Beside the checkpoints' directory: outputs/metrics.jsonl and
        # outputs/local/ for the default save_dir.
        self.metrics_path = Path(ckpt.save_dir).parent / "metrics.jsonl"
        self.media_dir = Path(ckpt.save_dir).parent / "local"
        self._dropout = torch.Generator(device=self.device)

    @torch.no_grad()
    def validate(self, state: TrainState, batch: dict, out_dir: str | Path | None = None,
                 save_media: bool | None = None) -> dict:
        """Render a validation batch in eval mode and return {"val_psnr"}: the
        mean PSNR over its target views. Saves the context | target |
        prediction grid of the first example, `validation_<step>.png`, and
        with `save_media` (default `trainer.val_save_media`) the projections
        and the wobble video, into `out_dir` (default `media_dir`)."""
        if save_media is None:
            save_media = self.cfg.trainer.val_save_media
        out_dir = Path(out_dir) if out_dir is not None else self.media_dir
        views = batch_to_device(batch, self.device)
        ctx, tgt = views["context"], views["target"]
        gaussians = state.encoder(*(ctx[k] for k in CONTEXT_KEYS))
        color = decode_splatting(
            gaussians, tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"], self.image_shape, cfg=self.cfg.decoder
        ).color
        psnr = float(compute_psnr(tgt["image"].reshape(-1, *tgt["image"].shape[-3:]),
                                  color.reshape(-1, *color.shape[-3:])).mean())
        context_row, gt_row, pred_row = (hcat(*x[0].cpu().numpy()) for x in (ctx["image"], tgt["image"], color))
        grid = vcat(
            add_label(context_row, "context"),
            add_label(gt_row, "target (gt)"),
            add_label(pred_row, f"prediction (psnr {psnr:.2f})"),
        )
        save_image(grid, out_dir / f"validation_{self.global_step:08d}.png")
        if save_media:
            self._save_validation_media(ctx, gaussians, out_dir)
        return {"val_psnr": psnr}

    def _save_validation_media(self, ctx: dict, gaussians: Gaussians, out_dir: Path) -> None:
        """The first example's Gaussians seen along three axes (a 128^2
        orthographic render each, with the context cameras' frusta drawn
        on), `projections_<step>.png`, and the 14-frame wobble around context
        camera 0 at 7 fps, `wobble_<step>.mp4`. The JAX Trainer encodes the
        context again for every wobble frame; in eval mode the Gaussians are
        a function of the context alone, so here one decode of 14 target
        views renders the frames from the Gaussians already made."""
        g0 = Gaussians(*(x[:1] for x in gaussians))
        looks, extent = axis_looks(g0.means[0].cpu().numpy())
        ortho = render_orthographic(
            Gaussians(*(x.expand(3, *x.shape[1:]).contiguous() for x in g0)),
            torch.as_tensor(np.stack([e for _, e in looks]), dtype=torch.float32, device=self.device),
            width=extent, height=extent, near=0.0, far=2.0 * extent, image_shape=(128, 128),
            cfg=self.cfg.decoder.rasterize,
        ).cpu().numpy()
        cams = ctx["extrinsics"][0].cpu().numpy()
        fx = 0.5 / np.tan(np.radians(0.05))
        view_intr = np.array([[fx, 0, 0.5], [0, fx, 0.5], [0, 0, 1.0]])
        panels = [
            add_label(draw_cameras(ortho[i], cams, e, view_intr, frustum_depth=0.2 * extent), f"ortho {name}")
            for i, (name, e) in enumerate(looks)
        ]
        save_image(hcat(*panels), out_dir / f"projections_{self.global_step:08d}.png")

        wobble = torch.as_tensor(validation_wobble(cams), dtype=torch.float32, device=self.device)
        n_frames = wobble.shape[0]

        def first_view(x: torch.Tensor) -> torch.Tensor:
            return x[:1, :1].expand(1, n_frames, *x.shape[2:]).contiguous()

        frames = decode_splatting(
            g0, wobble[None], first_view(ctx["intrinsics"]), first_view(ctx["near"]), first_view(ctx["far"]),
            self.image_shape, cfg=self.cfg.decoder,
        ).color[0].cpu().numpy()
        save_video(list(frames), out_dir / f"wobble_{self.global_step:08d}.mp4", fps=7)

    def _log_metrics(self, record: dict, path: str | Path | None = None) -> None:
        """Append-only JSONL metric log."""
        p = Path(path) if path is not None else self.metrics_path
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _step_generator(self) -> torch.Generator:
        """The dropout masks' generator for the step about to run. The JAX
        Trainer splits one key stream from PRNGKey(seed + 1) and starts it
        anew after a resume; here every step seeds from (seed + 1, step, dp
        rank) (`dropout_seed`), so a resumed run draws the masks the
        uninterrupted run would have."""
        dp_rank = self.mesh.dp_rank if self.mesh is not None else 0
        return self._dropout.manual_seed(dropout_seed(self.cfg.trainer.seed, self.global_step, dp_rank))

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

    def train_shard(self, worker_id: int = 0, num_workers: int = 0) -> dict:
        """make_dataset's striping of the training chunks for this rank (the
        main thread) or one of its loader workers: shard dp_rank of dp, or
        dp_rank * workers + worker of dp * workers with the worker's seed
        offset, as the JAX Trainer stripes by process and worker. The ranks
        of an sp group get the same shard (only sp rank 0 reads it: `fit`)."""
        dp, dp_rank = (self.mesh.dp, self.mesh.dp_rank) if self.mesh is not None else (1, 0)
        if num_workers <= 0:
            return {"shard_id": dp_rank, "num_shards": dp}
        return {"seed_offset": worker_id, "shard_id": dp_rank * num_workers + worker_id,
                "num_shards": dp * num_workers}

    def train_batches(self) -> Iterator[dict]:
        """Endless training batches from the chunks. The curriculum reads the
        live global step: through a shared multiprocessing.Value in forked
        workers (`trainer.num_workers` > 0), directly in the prefetch thread.
        Under a mesh the chunks are striped by dp rank: shard dp_rank of dp
        here, dp_rank * workers + worker of dp * workers in the workers."""
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
        mine = sum(len(self.make_dataset("train", **self.train_shard(w, nw)).chunks) for w in range(max(nw, 1)))
        self.log(f"data: {len(probe.chunks)} training chunk(s) under {cfg.dataset.roots}, JPEG route {route}, "
                 f"{nw} worker process(es)" + (f"; {mine} for dp rank {self.mesh.dp_rank}" if self.mesh else ""))
        if not mine:  # a rank with nothing to read would leave the others waiting in the step's collectives
            raise FileNotFoundError(f"dp rank {self.mesh.dp_rank} of {self.mesh.dp} has no training chunk to read: "
                                    f"{len(probe.chunks)} chunk(s) striped over {max(nw, 1)} loader(s) per rank")
        if nw <= 0:
            dataset = self.make_dataset("train", **self.train_shard(), jpeg_route=route)

            def epochs():
                while True:
                    yield from dataset.iter_examples(lambda: self.global_step)

            return iter(DataLoader(epochs(), cfg.trainer.batch_size))

        self._shared_step = mp.get_context("fork").Value("l", self.global_step)
        shared = self._shared_step
        in_workers = native.route_runs_in_workers(route)

        def make_worker_iter(worker_id: int):
            ds = self.make_dataset("train", **self.train_shard(worker_id, nw), jpeg_route=route)
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

    def _sp_shared(self, batches: Iterator[dict] | None) -> Iterator[dict] | None:
        """Under a mesh with sp > 1, the batches of sp rank 0 of this rank's
        dp group on every rank of the group (the other ranks' `batches` go
        unread and may be None): each batch's views move as one float32
        buffer on the device, its scene names and view indices as an object.
        The batches as they are otherwise."""
        mesh = self.mesh
        if mesh is None or mesh.sp == 1:
            return batches
        import torch.distributed as dist

        src = mesh.dp_rank * mesh.sp  # sp rank 0 of the group, by its global rank

        def shared():
            while True:
                head, views = [None], None
                if mesh.sp_rank == 0:
                    batch = next(batches, None)
                    if batch is not None:
                        views = batch_to_device(batch, self.device)
                        head = [{"scene": list(batch["scene"]),
                                 "index": {side: batch[side].get("index") for side in views},
                                 "shapes": {side: {k: tuple(v.shape) for k, v in views[side].items()}
                                            for side in views}}]
                dist.broadcast_object_list(head, src=src, group=mesh.sp_group)
                if head[0] is None:
                    return
                if views is None:
                    views = {side: {k: torch.empty(shape, device=self.device) for k, shape in shapes.items()}
                             for side, shapes in head[0]["shapes"].items()}
                leaves = [views[side][k] for side in sorted(views) for k in sorted(views[side])]
                flat = torch.cat([t.reshape(-1) for t in leaves])  # elsewhere only its size matters
                dist.broadcast(flat, src=src, group=mesh.sp_group)
                mesh.traffic["batch"] += flat.numel() * flat.element_size()
                offset = 0
                for t in leaves:
                    t.copy_(flat[offset : offset + t.numel()].view_as(t))
                    offset += t.numel()
                for side, index in head[0]["index"].items():
                    if index is not None:
                        views[side]["index"] = index
                yield {**views, "scene": head[0]["scene"]}

        return shared()

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
        loaders make them, under a mesh this rank's, and with sp > 1 only sp
        rank 0's is read; default: the training chunks, striped by dp rank)
        until `max_steps` or
        the iterator's end; returns the state. Validates on the held-out
        stream when test chunks exist, else on the current training batch.
        Resumes from `checkpointing.save_dir` when it holds a checkpoint, else
        warm-starts from `checkpointing.load`."""
        cfg = self.cfg
        max_steps = max_steps if max_steps is not None else cfg.trainer.max_steps
        self._shared_step = None
        own_iter = data_iter is None
        if own_iter and (self.mesh is None or self.mesh.sp_rank == 0):  # one loader per sp group
            data_iter = self.train_batches()
        val_iter = self.val_batches() if self.writer else None
        try:
            return self._fit(self._sp_shared(data_iter), val_iter, max_steps)
        finally:  # stop the loaders this call started (worker processes, prefetch threads)
            for it in ((data_iter,) if own_iter else ()) + ((val_iter,) if val_iter is not None else ()):
                if it is not None:
                    it.close()

    def _fit(self, data_iter: Iterator[dict], val_iter: Iterator[dict] | None, max_steps: int) -> TrainState:
        cfg = self.cfg
        mesh = self.mesh

        if self.writer:  # run-config snapshot, next to the run's checkpoints
            snapshot = Path(cfg.checkpointing.save_dir) / "config.json"
            snapshot.parent.mkdir(parents=True, exist_ok=True)
            snapshot.write_text(json.dumps(dataclasses.asdict(cfg), default=str, indent=1))

        first = next(data_iter)
        state = create_train_state(cfg.encoder, self.optimizer, self.lpips, device=self.device, seed=cfg.trainer.seed,
                                   ckpt_cfg=cfg.checkpointing)
        if cfg.checkpointing.pretrained_model or cfg.checkpointing.dav2_weights:
            self.log(f"loaded pretrained weights: model={cfg.checkpointing.pretrained_model} "
                     f"dav2={cfg.checkpointing.dav2_weights}")
        restored = None
        if self.writer:
            restored = self.ckpt.restore(state)
            if restored is None and cfg.checkpointing.load:
                # Warm start from another run's checkpoints when this run's directory is fresh.
                restored = CheckpointManager(cfg.checkpointing.load).restore(state)
        if restored is not None:
            state = restored
        if mesh is not None:  # rank 0's state, restored or fresh, on every rank
            state = replicated(state, mesh)
        if state.step:
            self.global_step = state.step
            if self._shared_step is not None:
                self._shared_step.value = self.global_step
            rank = f" (rank {mesh.rank} of {mesh.world})" if mesh is not None and mesh.world > 1 else ""
            self.log(f"resumed from step {self.global_step}{rank}")

        def validate(fallback: dict) -> dict:
            batch = next(val_iter) if val_iter is not None else fallback
            return {**self.validate(state, batch), "val_scenes": list(batch["scene"])}

        v = cfg.trainer.val_check_interval
        val_interval = max(1, int(v if v > 1 else v * max_steps))
        every = self.ckpt.every_n_steps
        if self.writer:
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

            if self.writer and self.global_step % self.log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}  # reads the values: waits for the device
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                self.log(
                    f"step {self.global_step}: loss={metrics['loss']:.4f} "
                    f"psnr={metrics.get('psnr', 0):.2f} ({dt / self.log_every:.3f}s/it)"
                )
                self._log_metrics({"step": self.global_step, "s_per_it": dt / self.log_every, **metrics})
            validating = self.global_step % val_interval == 0
            if self.writer:
                if validating:
                    self._log_metrics({"step": self.global_step, **validate(batch)})
                self.ckpt.maybe_save(self.global_step, state)
            if mesh is not None and (validating or (every > 0 and self.global_step % every == 0)):
                mesh.barrier()  # the others wait while rank 0 writes

            try:
                batch = next(data_iter)
            except StopIteration:
                break

        if self.writer:
            self.ckpt.save(self.global_step, state)
        if mesh is not None:
            mesh.barrier()
        return state
