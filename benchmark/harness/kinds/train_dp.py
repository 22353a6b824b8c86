"""The "train_dp" kind: the "train" kind's step (kinds/train.py) data-parallel
over the mix's `dp` ranks of one host, one card each.

The run's process is rank 0 on its card (`cuda:0`); it starts ranks 1 ..
dp - 1 on cards 1 .. dp - 1 through the program's `parallel.launch.start_peers`
(spawned processes) and joins them in one group (`parallel.mesh.make_mesh`,
NCCL on cards, gloo on the CPU). Every rank builds the program's
`make_train_step` with the mesh from the same seeded weights and takes
`trainer.batch_size` examples of each global batch (the pool: the mix's
`scenes` in global batches of dp x batch_size, placed on the cards at
set-up); rank r draws its dropout masks from a stream of its own. A unit is
one step on every rank: rank 0 sends it to the others over a gloo group of
the benchmark's own, and the unit ends when every rank has synchronised its
card after its step. The traced window traces rank 0.

`train_examples_per_s` counts the dp x batch_size examples of a step;
`train_peak_GiB` is the largest peak of allocated memory of the ranks over
the window.

The comparison is the "train" kind's, with its limits: the program's first
three steps (the world's loss, the optimizer's first gradient, each leaf's
change) against the plain reference (benchmark/reference/train.py) run on
every rank for its own shard with its own dropout masks, the four ranks'
losses and gradients averaged before the clip, and BatchNorm's training
statistics taken over the batch joined across the ranks, as the data-
parallel step takes them (`joined_batch_norm`: each of the reference's
BatchNorms runs its own forward on every rank's input, gathered).

The result line's device record counts the run's cards: cellrun's
`device_info` counts one, and a kind has no say in it, so this kind wraps
it for the run's process (`_count_cards`).
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import os
import sys
import threading
import time

import torch
import torch.distributed as dist

from .. import serving
from ..driver import closed_loop
from ..spec import Cell, build_dataclass
from ..traffic import make_scenes, request_order, stream_seed
from ..weights import load_parameters
from . import train

STREAM_DROPOUT_RANK = 41  # rank r's dropout masks: stream 41 + r of the run's seed
STEP, RESET_PEAK, PEAK, RELEASE, REFERENCE, QUIT = range(1, 7)
CONTROL_TIMEOUT = datetime.timedelta(seconds=300)


def _shard(batch: dict, rank: int, size: int) -> dict:
    """Rank `rank`'s examples of a global batch."""
    return {part: {k: v[rank * size : (rank + 1) * size].contiguous() for k, v in views.items()}
            for part, views in batch.items()}


class _Joined(torch.autograd.Function):
    """Every rank's x joined along the batch, in rank order; the gradient of
    this rank's part is the joined gradient summed over the ranks, sliced."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous())
        ctx.rank, ctx.n = rank, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[ctx.rank * ctx.n : (ctx.rank + 1) * ctx.n], None, None


@contextlib.contextmanager
def joined_batch_norm(module: torch.nn.Module, rank: int, world: int):
    """Inside, each of the reference's BatchNorms in `module`
    (benchmark/reference/model/layers.py), in training mode, runs its own
    forward on the batch joined over the `world` ranks and hands on this
    rank's part: the mean and biased variance of the joined batch, the
    running statistics moved towards them, and the statistics' gradient
    reaching every rank's inputs."""
    from benchmark.reference.model.layers import _FlaxBatchNorm

    def join(m, args):
        return (_Joined.apply(args[0], rank, world),) if m.training else None

    def part(m, args, out):
        if m.training:
            n = out.shape[0] // world
            return out[rank * n : (rank + 1) * n]
        return None

    handles = []
    for m in module.modules():
        if isinstance(m, _FlaxBatchNorm):
            handles += [m.register_forward_pre_hook(join), m.register_forward_hook(part)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _count_cards(world: int) -> None:
    """The result line's device record counts the `world` cards of the run."""
    from .. import cellrun

    one = cellrun.device_info
    cellrun.device_info = lambda device, peak: {**one(device, peak), "count": world}


class Rank(train.Driver):
    """One rank's program and its part of every command; rank 0 is the
    run's `Driver`, the others run `serve_commands`."""

    def __init__(self, cell: Cell, seed: int, rank: int, world: int, device: torch.device):
        from transplat_tpu_torch.config import OptimizerCfg, TrainerCfg
        from transplat_tpu_torch.loss import LPIPS, LossCfg
        from transplat_tpu_torch.model.decoder import DecoderCfg
        from transplat_tpu_torch.model.encoder import EncoderCfg
        from transplat_tpu_torch.parallel.mesh import make_mesh
        from transplat_tpu_torch.training import create_train_state, make_lr_schedule, make_optimizer, make_train_step

        self.config, self.traffic, self.seed, self.device = cell.config, cell.traffic, seed, device
        self.rank, self.world = rank, world
        cfg = self.config
        if cfg["precision"] == "float32":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        self.mesh = make_mesh(dp=world, device=device)
        self.control = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
        self.image_shape = tuple(cfg["image_shape"])
        self.trainer = train.followed(cfg, "trainer", TrainerCfg)
        self.opt = train.followed(cfg, "optimizer", OptimizerCfg)
        loss_cfg = train.followed(cfg, "loss", LossCfg)
        self.loss = {k: getattr(loss_cfg, k) for k in train.FOLLOWED["loss"]}
        self.batch_size = self.trainer.batch_size
        encoder_cfg = build_dataclass(EncoderCfg, cfg["encoder"])
        optimizer = make_optimizer(
            make_lr_schedule(self.opt.lr, self.trainer.max_steps, self.opt.cosine_lr, self.opt.warm_up_steps),
            grad_clip=self.opt.gradient_clip_val,
        )
        self.b1 = optimizer.b1
        lpips = LPIPS(device=device)  # draws its own start on the host; every value is replaced
        load_parameters(lpips, self.lpips_weights())
        with torch.device(device):
            self.state = create_train_state(encoder_cfg, optimizer, lpips, device=device)
        load_parameters(self.state.encoder, serving.seeded_weights(cfg, seed, device))
        self.step = make_train_step(
            encoder_cfg, loss_cfg, build_dataclass(DecoderCfg, cfg["decoder"]), optimizer, self.image_shape,
            deterministic_kernels=self.trainer.deterministic_kernels, mesh=self.mesh,
        )
        pool = train._batches(make_scenes(self.traffic, cfg, seed, device), world * self.batch_size)
        self.batches = [_shard(b, rank, self.batch_size) for b in pool]
        self.order = request_order({"scenes": len(self.batches)}, seed)
        self.generator = torch.Generator(device=device).manual_seed(stream_seed(seed, STREAM_DROPOUT_RANK + rank))
        self.generator_start = self.generator.get_state()
        self._first_steps()

    # ---- commands ---------------------------------------------------------------

    def handle(self, cmd: int, arg: int):
        if cmd == STEP:
            self.state, _ = self.step(self.state, self._batch(self.steps_done), self.generator)
            self.steps_done += 1
            serving.sync(self.device)
            dist.barrier(group=self.control)
        elif cmd == RESET_PEAK:
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
        elif cmd == PEAK:
            peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
            t = torch.tensor([peak], dtype=torch.int64)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
            return int(t)
        elif cmd == RELEASE:
            self.state = None
            serving.free(self.device)
        elif cmd == REFERENCE:
            return self.rank_reference_steps(bool(arg))
        return None

    def serve_commands(self) -> None:
        """Take rank 0's commands until it sends QUIT."""
        while True:
            msg = torch.zeros(2, dtype=torch.int64)
            dist.broadcast(msg, 0, group=self.control)
            if int(msg[0]) == QUIT:
                return
            self.handle(int(msg[0]), int(msg[1]))

    # ---- the reference ------------------------------------------------------------

    def _mean_over_ranks(self, loss: torch.Tensor, grads: dict) -> tuple[torch.Tensor, dict]:
        names = list(grads)
        flat = torch.cat([loss.reshape(1)] + [grads[k].reshape(-1) for k in names])
        dist.all_reduce(flat)
        flat /= self.world
        out, offset = {}, 1
        for k in names:
            n = grads[k].numel()
            out[k] = flat[offset : offset + n].view_as(grads[k])
            offset += n
        return flat[0], out

    def rank_reference_steps(self, tf32: bool = False) -> tuple[list[float], dict, dict, dict]:
        """The reference's first three steps of the data-parallel run, on this
        rank's shard (see the module docstring): (the world's losses, the
        first clipped gradient's leaf norms, that gradient, each leaf's change
        over the three updates), the same on every rank."""
        from benchmark.reference import train as ref

        cfg = self.config
        encoder = serving.reference_encoder(cfg, self.device, serving.seeded_weights(cfg, self.seed, self.device))
        lpips = train.reference_lpips(self.device, self.lpips_weights())
        params = {k: p for k, p in encoder.named_parameters() if p.requires_grad}
        start = {k: p.detach().clone() for k, p in params.items()}
        rate = ref.schedule(self.opt.lr, self.trainer.max_steps, self.opt.cosine_lr, self.opt.warm_up_steps)
        adam = ref.Adam()
        gen = torch.Generator(device=self.device)
        gen.set_state(self.generator_start)
        bg = torch.tensor(cfg["decoder"]["background_color"], dtype=torch.float32, device=self.device)
        losses, first = [], None
        with serving.precision(tf32), joined_batch_norm(encoder, self.rank, self.world):
            for i in range(train.CHECKED_STEPS):
                loss, grads = ref.loss_and_grads(encoder, lpips, self._batch(i), i, gen, self.loss, self.image_shape, bg)
                loss, grads = self._mean_over_ranks(loss, grads)
                grads = ref.clip(grads, self.opt.gradient_clip_val)
                if i == 0:
                    first = grads
                ref.adam_update(params, grads, adam, rate(adam.count))
                losses.append(float(loss))
        change = {k: p.detach() - start[k] for k, p in params.items()}
        return losses, train.leaf_norms(first), first, change


def _peer(cell: Cell, seed: int, world: int, device_type: str) -> None:
    """A rank above 0: its program, then rank 0's commands until QUIT, then
    out at once (a group's teardown would wait on rank 0, which waits for
    this process to end)."""
    rank = int(os.environ["RANK"])
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    Rank(cell, seed, rank, world, device).serve_commands()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


class Driver(Rank):
    """Rank 0: starts the others, joins them, and sends every unit and every
    phase of the run to all of them."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        from transplat_tpu_torch.parallel.launch import join_as_rank, start_peers
        from transplat_tpu_torch.parallel.mesh import free_port

        world = int(cell.traffic["dp"])
        if device.type == "cuda" and torch.cuda.device_count() < world:
            raise RuntimeError(f"dp = {world} needs {world} cards; found {torch.cuda.device_count()}")
        per_step = world * int(cell.config["trainer"]["batch_size"])
        if cell.traffic["scenes"] < per_step:
            raise ValueError(f"the pool's {cell.traffic['scenes']} scenes hold no global batch of {per_step}")
        port = free_port()
        threads = max(1, min(8, (os.cpu_count() or world) // world))
        self._quitting = False
        self.peers = start_peers(_peer, world, cell, seed, world, device.type, port=port, threads=threads)
        _count_cards(world)
        self._watch_peers()
        join_as_rank(0, world, port)
        super().__init__(cell, seed, 0, world, device)
        atexit.register(self._quit)

    def _watch_peers(self) -> None:
        """End the run at once if a peer dies with an error (its collectives
        would otherwise hold rank 0 until their time-out)."""

        def watch():
            while not self._quitting:
                for r, p in enumerate(self.peers.processes, start=1):
                    if not p.is_alive() and p.exitcode not in (0, None):
                        print(f"rank {r} ended with exit code {p.exitcode}", file=sys.stderr, flush=True)
                        os._exit(1)
                time.sleep(0.5)

        threading.Thread(target=watch, daemon=True).start()

    def command(self, cmd: int, arg: int = 0):
        dist.broadcast(torch.tensor([cmd, arg], dtype=torch.int64), 0, group=self.control)
        return self.handle(cmd, arg)

    def _quit(self) -> None:
        """At the process's exit: the peers leave, then the group is torn down."""
        self._quitting = True
        with contextlib.suppress(Exception):
            dist.broadcast(torch.tensor([QUIT, 0], dtype=torch.int64), 0, group=self.control)
            for p in self.peers.processes:
                p.join(timeout=30)
            dist.destroy_process_group()

    def run_unit(self, i: int, keep: bool) -> None:
        """One step on every rank, ended when every rank has synchronised."""
        self.command(STEP)

    def window(self, seconds: float, sample: int, seed: int):
        self.command(RESET_PEAK)
        out = closed_loop(self, seconds, sample, seed)
        self.window_peak = self.command(PEAK)
        return out

    def end_to_end(self, latencies: list[float], window_s: float, peak: int) -> dict[str, float]:
        """Examples of every rank per second over the window, and the largest
        peak of the ranks' allocated memory in it."""
        return {
            "train_examples_per_s": len(latencies) * self.world * self.batch_size / window_s,
            "train_peak_GiB": max(peak, self.window_peak) / 2**30,
        }

    def release(self) -> None:
        self.command(RELEASE)

    def reference_steps(self, tf32: bool = False):
        return self.command(REFERENCE, int(tf32))
