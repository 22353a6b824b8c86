"""The "train" kind: one object, the program's training step with its model
and optimizer state, built from the seeded weights, driven through its
first steps at set-up and then through the window.

A unit is one step of the program's `make_train_step` over
`create_train_state` (as `train_demo.build` assembles them) on a batch of
the pool, which set-up places on the card; the step ends in a synchronize.
Each step draws its dropout masks from one generator seeded by the
benchmark. The first three steps run at set-up, on three different
batches, and leave behind what the reference checks: each step's loss, the
first gradient as the optimizer got it (its first moment after one update,
over 1 - b1), and each leaf's change over the three updates. The reference
then follows the same three steps from the same weights, batches and
generator state, after the window.

The configuration's `trainer`, `optimizer` and `loss` sections are built
into the program's own dataclasses, so a key the program lacks raises, and
a key that neither this driver nor the reference follows is refused.
`trainer.deterministic_kernels` is handed to the program's step; the
reference needs no switch for it, since the sorted kernels compute the
same sums in a fixed order.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import serving
from ..driver import Driver as Base
from ..spec import Cell, build_dataclass
from ..traffic import make_scenes, request_order, stream_seed
from ..weights import load_parameters, seeded_parameters

STREAM_DROPOUT, STREAM_LPIPS = 31, 12
CHECKED_STEPS = 3
# A value whose first gradient in the reference is under this share of the
# median leaf's root mean square moves under Adam by rounding alone (a key's
# bias under softmax): its change is not compared.
STILL = 1e-3
# The keys of each section that the program's step and the reference both follow.
FOLLOWED = {
    "trainer": {"batch_size", "max_steps", "deterministic_kernels"},
    "optimizer": {"lr", "warm_up_steps", "cosine_lr", "gradient_clip_val"},
    "loss": {"mse_weight", "lpips_weight", "lpips_apply_after_step"},
}


def followed(config: dict, section: str, cls):
    """The program's dataclass `cls` built from `config[section]`; a key that
    the program, this driver or the reference does not follow raises."""
    built = build_dataclass(cls, config[section])  # a key the program lacks raises here
    unfollowed = sorted(set(config[section]) - FOLLOWED[section])
    if unfollowed:
        raise ValueError(f"{section}: {unfollowed} are not followed by the benchmark's training step or its reference")
    return built


def _batches(scenes, batch_size: int) -> list[dict]:
    """Consecutive scenes stacked into batches of `batch_size`."""
    out = []
    for i in range(0, len(scenes) - batch_size + 1, batch_size):
        group = scenes[i : i + batch_size]
        out.append({
            part: {k: torch.cat([getattr(s, part)[k] for s in group]) for k in getattr(group[0], part)}
            for part in ("context", "targets")
        })
    return [{"context": b["context"], "target": b["targets"]} for b in out]


def reference_lpips(device, weights: dict | None = None):
    from benchmark.reference.loss.vgg import LPIPS

    dev = "meta" if weights is None else device
    with torch.device(dev):
        lpips = LPIPS()
    if weights is not None:
        load_parameters(lpips, weights)
    return lpips.requires_grad_(False)


def leaf_norms(tensors: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def median_gap(prog: dict[str, float], ref: dict[str, float]) -> float:
    """The median over the leaves of `ref` of |program norm - reference norm|
    over the reference norm."""
    return float(np.median([abs(prog[k] - v) / v for k, v in ref.items()]))


def worst_gap(prog: dict[str, float], ref: dict[str, float]) -> float:
    """The largest over the leaves of `ref` of |program norm - reference norm|
    over the larger of the leaf's reference norm and the median leaf's (some
    leaves are all but still)."""
    median = float(np.median(list(ref.values())))
    return max(abs(prog[k] - v) / max(v, median) for k, v in ref.items())


def moving_change(change: dict, ref_grad: dict) -> dict[str, float]:
    """Each moving leaf's norm of `change` over its moving values: a leaf
    moves where its reference gradient's norm is at least STILL times the
    median leaf's, a value where its reference gradient is at least STILL
    times the median leaf's root mean square (a key's bias inside a leaf of
    query, key and value biases does not)."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref_grad.items()}
    median = float(np.median(list(norms.values())))
    rms = float(np.median([norms[k] / g.numel() ** 0.5 for k, g in ref_grad.items()]))
    out = {}
    for k, g in ref_grad.items():
        mask = g.abs() >= STILL * rms
        if norms[k] >= STILL * median and bool(mask.any()):
            out[k] = float(torch.linalg.vector_norm(change[k].to(g.device).double()[mask]))
    return out


class Driver(Base):
    def __init__(self, cell: Cell, seed: int, device: torch.device):
        from transplat_tpu_torch.config import OptimizerCfg, TrainerCfg
        from transplat_tpu_torch.loss import LPIPS, LossCfg
        from transplat_tpu_torch.model.decoder import DecoderCfg
        from transplat_tpu_torch.model.encoder import EncoderCfg
        from transplat_tpu_torch.training import create_train_state, make_lr_schedule, make_optimizer, make_train_step

        self.config, self.traffic, self.seed, self.device = cell.config, cell.traffic, seed, device
        cfg = self.config
        self.image_shape = tuple(cfg["image_shape"])
        self.trainer = followed(cfg, "trainer", TrainerCfg)
        self.opt = followed(cfg, "optimizer", OptimizerCfg)
        loss_cfg = followed(cfg, "loss", LossCfg)
        self.loss = {k: getattr(loss_cfg, k) for k in FOLLOWED["loss"]}
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
            deterministic_kernels=self.trainer.deterministic_kernels,
        )
        self.batches = _batches(make_scenes(self.traffic, cfg, seed, device), self.batch_size)
        self.order = request_order({"scenes": len(self.batches)}, seed)
        self.generator = torch.Generator(device=device).manual_seed(stream_seed(seed, STREAM_DROPOUT))
        self.generator_start = self.generator.get_state()
        self._first_steps()

    def lpips_weights(self) -> dict:
        return seeded_parameters(reference_lpips(self.device), self.seed, self.device, stream=STREAM_LPIPS)

    def _batch(self, i: int) -> dict:
        return self.batches[int(self.order[i % len(self.order)])]

    def _first_steps(self) -> None:
        """Steps 1-3 through the window's own call, recording what the reference checks."""
        losses = []
        for i in range(CHECKED_STEPS):
            _, metrics = self.step(self.state, self._batch(i), self.generator)
            losses.append(float(metrics["loss"]))
            if i == 0:
                mu = self.state.opt_state.mu
                self.first_grad = leaf_norms({k: m / (1.0 - self.b1) for k, m in mu.items()})
        start = serving.seeded_weights(self.config, self.seed, self.device)
        self.change = {k: (p.detach() - start[k]).cpu() for k, p in self.state.trainable().items()}
        self.losses = losses
        self.steps_done = CHECKED_STEPS

    def run_unit(self, i: int, keep: bool) -> None:
        """One step, on the next batch of the pool (`i` counts the window's units)."""
        self.state, _ = self.step(self.state, self._batch(self.steps_done), self.generator)
        self.steps_done += 1
        serving.sync(self.device)

    def end_to_end(self, latencies: list[float], window_s: float, peak: int) -> dict[str, float]:
        """Examples per second over the whole window, and the window's peak of
        allocated memory (set back before the window)."""
        return {"train_examples_per_s": len(latencies) * self.batch_size / window_s, "train_peak_GiB": peak / 2**30}

    # spans: the program's own, train.encoder, .decoder, .loss, .backward, .optimizer

    def release(self) -> None:
        self.state = None
        serving.free(self.device)

    def reference_steps(self, tf32: bool = False) -> tuple[list[float], dict, dict, dict]:
        """The reference's first three steps from the seed: (losses, first
        clipped gradient's leaf norms, the gradient itself, each leaf's
        change over the three updates)."""
        from benchmark.reference import train as ref

        cfg = self.config
        encoder = serving.reference_encoder(cfg, self.device, serving.seeded_weights(cfg, self.seed, self.device))
        lpips = reference_lpips(self.device, self.lpips_weights())
        params = {k: p for k, p in encoder.named_parameters() if p.requires_grad}
        start = {k: p.detach().clone() for k, p in params.items()}
        rate = ref.schedule(self.opt.lr, self.trainer.max_steps, self.opt.cosine_lr, self.opt.warm_up_steps)
        adam = ref.Adam()
        gen = torch.Generator(device=self.device)
        gen.set_state(self.generator_start)
        bg = torch.tensor(cfg["decoder"]["background_color"], dtype=torch.float32, device=self.device)
        losses, first = [], None
        with serving.precision(tf32):
            for i in range(CHECKED_STEPS):
                loss, grads = ref.loss_and_grads(encoder, lpips, self._batch(i), i, gen, self.loss, self.image_shape, bg)
                grads = ref.clip(grads, self.opt.gradient_clip_val)
                if i == 0:
                    first = grads
                ref.adam_update(params, grads, adam, rate(adam.count))
                losses.append(float(loss))
        change = {k: p.detach() - start[k] for k, p in params.items()}
        return losses, leaf_norms(first), first, change

    def compare(self, samples, control: bool = False) -> dict[str, float]:
        """The program's (or, with `control`, the TF32 reference's) first
        three steps against the reference's: the relative loss gap of the
        first step and of the worst step; over the moving leaves, the
        relative gap of the first gradient's norm and of the change's norm
        over the three updates, each of the median leaf and of the worst.
        The worst leaf and the later steps swing from seed to seed: the
        render's hard edges (the radius, the 1/255 alpha floor, the
        saturated pixel) turn float32 rounding into a few Gaussians'
        contributions on or off, which moves the depth path's leaves by
        percents and the loss by 1e-6 to 1e-5 on some seeds, and Adam's
        later steps turn rounding in values whose gradients cancel from step
        to step into changes of sign. The mix's limits name the numbers a
        run compares; the worst step's loss and the worst leaf's change are
        read for the control test, and the first step and the median leaf's
        change stand in for them."""
        if control:
            losses, first, _, change = self.reference_steps(tf32=True)
        else:
            losses, first, change = self.losses, self.first_grad, self.change
        ref_losses, ref_first, ref_grad, ref_change = self.reference_steps()
        median = float(np.median(list(ref_first.values())))
        moving = {k: v for k, v in ref_first.items() if v >= STILL * median}
        prog_change, ref_moved = moving_change(change, ref_grad), moving_change(ref_change, ref_grad)
        loss_gaps = [abs(p - r) / abs(r) for p, r in zip(losses, ref_losses)]
        return {
            "loss_first_rel": loss_gaps[0],
            "loss_worst_rel": max(loss_gaps),
            "grad_median_gap": median_gap(first, moving),
            "grad_leaf_gap": worst_gap(first, moving),
            "change_median_gap": median_gap(prog_change, ref_moved),
            "change_leaf_gap": worst_gap(prog_change, ref_moved),
        }

    def counts(self, traced) -> dict[str, float]:
        """A step's FLOPs, counted on the reference at the cell's shapes."""
        from benchmark.metrics import counting
        from benchmark.reference.model import uv_transformer
        from benchmark.reference.render import composite_view, project_view

        cfg = self.config
        encoder = serving.reference_encoder(cfg, self.device, serving.seeded_weights(cfg, self.seed, self.device))
        lpips = reference_lpips(self.device, self.lpips_weights())
        batch = self._batch(0)
        gen = torch.Generator(device=self.device)
        gen.set_state(self.generator_start)
        bg = torch.tensor(cfg["decoder"]["background_color"], dtype=torch.float32, device=self.device)
        tgt = batch["target"]
        with serving.precision(False):
            with torch.no_grad():
                ctx = batch["context"]
                g = encoder(ctx["image"], ctx["intrinsics"], ctx["extrinsics"], ctx["near"], ctx["far"])
                kept = 0
                for e in range(g.means.shape[0]):
                    for v in range(tgt["extrinsics"].shape[1]):
                        proj = project_view(g.means[e], g.covariances[e], g.harmonics[e], g.opacities[e],
                                            tgt["extrinsics"][e, v], tgt["intrinsics"][e, v], tgt["near"][e, v],
                                            self.image_shape)
                        kept += composite_view(proj, self.image_shape, bg)[1]
            flops = counting.train_step_flops(encoder, lpips, uv_transformer, batch, gen, kept)
        return {"flops_per_unit": flops}
