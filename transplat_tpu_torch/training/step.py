"""Training step: forward (encoder -> decoder -> losses), backward, clip + Adam.

Counterpart of transplat_tpu/training/step.py. The encoder module holds the
parameters and the BatchNorm statistics, and the step updates them in place
(JAX's `donate` has no counterpart). With a `mesh` (parallel/mesh.py) a step
runs on every rank of a dp x sp mesh and equals the one-process step on the
joined batch; see `make_train_step`. On the card the gradients of the deformable
sampler and of the rasterizer come from the hand-written backward kernels
(ops/deform.py, ops/rasterizer/composite.py); everything else is autograd.
The stages of a step are marked with spans (utils/trace.py: `train.*`),
which profile_training.py and the benchmark read.

Under the encoder's `compute_dtype="bfloat16"` the depth predictor and the
loss's LPIPS compute in bfloat16; the parameters, their gradients and the
Adam moments stay float32. `remat_unet` / `remat_matching` recompute the
U-Nets / the UV fine layers in the backward (model/layers.py `checkpointed`).

`deterministic_kernels` makes a step on the card repeat its bits, as the JAX
step does by construction: K2 and K8 take their sorted modes, K6 refuses a
shape it cannot sum in a fixed order (K4 and the forward kernels repeat
their bits anyway), and the step runs under `repeatable_ops`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable

import torch

from ..loss.losses import LossCfg, compute_losses
from ..loss.vgg import LPIPS, init_lpips
from ..model.decoder import DecoderCfg, decode_splatting
from ..model import build_encoder
from ..model.encoder import EncoderCfg, EncoderTranSplat
from ..dataset.loader import CONTEXT_KEYS
from ..evaluation.metrics import compute_psnr
from ..model.init import init_parameters
from ..model.layers import Dropout, batch_stats_over
from ..parallel.mesh import all_reduce_mean_, constrain, view_slice
from ..utils.trace import span


@dataclass
class AdamState:
    """First and second moments by parameter name, and the number of updates made."""

    count: int = 0
    mu: dict[str, torch.Tensor] = field(default_factory=dict)
    nu: dict[str, torch.Tensor] = field(default_factory=dict)


class ClipAdam:
    """optax.chain(clip_by_global_norm(grad_clip), adam(lr_schedule)), written out.

    The clip is optax's: g * clip / max(norm, clip), with no epsilon on the
    norm. Adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
    correction by the number of updates, the learning rate of the count
    before the update."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr_schedule: Callable[[int], float], grad_clip: float = 0.5):
        self.lr_schedule, self.grad_clip = lr_schedule, grad_clip

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        return AdamState(
            0, {k: torch.zeros_like(p) for k, p in params.items()}, {k: torch.zeros_like(p) for k, p in params.items()}
        )

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor], state: AdamState) -> torch.Tensor:
        """Update `params` and `state` in place; returns the gradients' global norm (before the clip)."""
        names = list(params)
        g = [grads[k] for k in names]
        mu, nu = [state.mu[k] for k in names], [state.nu[k] for k in names]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        g = torch._foreach_mul(g, self.grad_clip / torch.clamp(norm, min=self.grad_clip))
        torch._foreach_lerp_(mu, g, 1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        lr = self.lr_schedule(state.count)
        state.count += 1
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - self.b2**state.count))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_([params[k] for k in names], mu, denom, value=-lr / (1.0 - self.b1**state.count))
        return norm


def make_optimizer(lr_schedule: Callable[[int], float], grad_clip: float = 0.5) -> ClipAdam:
    return ClipAdam(lr_schedule, grad_clip)


@dataclass
class TrainState:
    step: int
    encoder: EncoderTranSplat  # parameters and BatchNorm statistics (or EncoderEpipolar, evaluation only)
    lpips: LPIPS | None  # frozen; None trains without the perceptual term
    opt_state: AdamState

    def trainable(self) -> dict[str, torch.Tensor]:
        """The encoder's parameters that take gradients (all but the frozen DAv2), by name."""
        return {k: p for k, p in self.encoder.named_parameters() if p.requires_grad}


def create_train_state(
    encoder_cfg: EncoderCfg,
    optimizer: ClipAdam,
    lpips: LPIPS | None = None,
    device: str | torch.device = "cuda",
    seed: int | None = None,
    ckpt_cfg=None,
) -> TrainState:
    """A fresh state on `device`: a new encoder (`model.build_encoder`: an
    EncoderTranSplat, or pixelSplat's EncoderEpipolar), step 0, zero Adam
    moments. With a `seed` the parameters are drawn as the JAX package's
    initialisers draw them (model/init.py), for training from scratch;
    without one they keep PyTorch's default initialisation, for a caller who
    loads or draws the weights afterwards.

    ckpt_cfg: a CheckpointingCfg whose `pretrained_model` / `dav2_weights`
    .npy trees are merged over those parameters (training/pretrained.py).
    A Lightning tree's embedded LPIPS becomes the state's LPIPS when no
    `lpips` is given."""
    state = TrainState(step=0, encoder=build_encoder(encoder_cfg, device=device), lpips=lpips, opt_state=AdamState())
    if seed is not None:
        init_parameters(state.encoder, seed)
    if ckpt_cfg is not None and (ckpt_cfg.pretrained_model or ckpt_cfg.dav2_weights):
        from .pretrained import load_pretrained_variables

        lpips_state = load_pretrained_variables(state.encoder, ckpt_cfg)
        if lpips_state and state.lpips is None:
            state.lpips = init_lpips(lpips_state, device)
    state.opt_state = optimizer.init(state.trainable())
    return state


@contextlib.contextmanager
def repeatable_ops(on: bool = True):
    """Inside, PyTorch's own operations repeat their bits from run to run:
    cuDNN takes deterministic algorithms and no benchmark search, and
    `torch.use_deterministic_algorithms(True, warn_only=True)` swaps in
    deterministic versions of the operations that have them (the scatter
    behind an indexing gather's backward, for one) and warns about any that
    has none (without filling fresh allocations, which the port's kernels
    write in full). Everything is put back on leaving. Off: nothing changes."""
    if not on:
        yield
        return
    import torch.utils.deterministic

    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(), torch.utils.deterministic.fill_uninitialized_memory)
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved[0], saved[1]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
        torch.utils.deterministic.fill_uninitialized_memory = saved[4]


def _loss_lpips(state: TrainState):
    """The training loss's LPIPS: its convolutions at the encoder's compute
    dtype, as in the JAX step (the evaluator's LPIPS stays float32)."""
    lpips, dtype = state.lpips, state.encoder.cfg.torch_dtype
    if lpips is None or dtype is None:
        return lpips
    return lambda a, b: lpips(a, b, dtype=dtype)


def loss_and_grads(
    state: TrainState,
    batch: dict,
    loss_cfg: LossCfg,
    decoder_cfg: DecoderCfg,
    image_shape: tuple[int, int],
    generator: torch.Generator | None = None,
    deterministic: bool = False,
    deterministic_kernels: bool = False,
    mesh=None,
):
    """One forward and backward of the training loss in training mode (batch
    statistics in BatchNorm, which move their running ones; dropout from
    `generator` unless `deterministic`; with `deterministic_kernels` the
    same bits on every run, see the module docstring). Returns (metrics,
    gradients by parameter name), the loss under metrics["loss"]; the encoder
    is back in eval mode afterwards.

    mesh: this rank's part of a dp x sp step (`make_train_step`): BatchNorm
    statistics joined over the dp group, the rank's slice of the Gaussians
    up to the decode boundary, the loss on the rank's own target views. The
    gradients and metrics returned are this rank's, not yet reduced."""
    encoder = state.encoder
    params = state.trainable()
    encoder.train()
    for m in encoder.modules():
        if isinstance(m, Dropout):
            m.train(not deterministic)
    stats_group = mesh.dp_group if mesh is not None and mesh.dp > 1 else None
    try:
        ctx, tgt = batch["context"], batch["target"]
        with repeatable_ops(deterministic_kernels), batch_stats_over(encoder, stats_group, mesh):
            with span("train.encoder"):
                gaussians = encoder(
                    *(ctx[k] for k in CONTEXT_KEYS), global_step=state.step, generator=generator,
                    deterministic_kernels=deterministic_kernels,
                )
                gaussians = constrain(gaussians, mesh)
            with span("train.decoder"):
                out = decode_splatting(
                    gaussians, tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"], image_shape,
                    cfg=decoder_cfg, deterministic_kernels=deterministic_kernels, mesh=mesh,
                )
                target = tgt["image"][:, view_slice(tgt["image"].shape[1], mesh)]
            with span("train.loss"):
                loss, parts = compute_losses(loss_cfg, out.color, target, state.step, lpips_fn=_loss_lpips(state))
            with span("train.backward"):
                grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    finally:
        encoder.eval()
    metrics = {k: v.detach() for k, v in parts.items()}
    with torch.no_grad():
        metrics["loss"] = loss.detach()
        metrics["render_overflow"] = out.overflow.sum().to(torch.float32)
        # One PSNR over the whole batch (every view in one mean), as the JAX step reports it.
        metrics["psnr"] = compute_psnr(target.reshape(1, -1, 3), out.color.reshape(1, -1, 3))
        if mesh is not None:  # the rank's share of the world's PSNR (_world_metrics)
            metrics["psnr_mse"] = torch.mean((target.clamp(0.0, 1.0) - out.color.clamp(0.0, 1.0)) ** 2)
    # A parameter the loss does not reach has gradient 0, as in JAX.
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
    return metrics, grads


@torch.no_grad()
def _world_metrics(metrics: dict, target_mse: torch.Tensor, mesh) -> dict:
    """The metrics of the whole step: means over the world (every rank's
    shard is the same size, so the mean of the ranks' means is the global
    mean), the overflow summed, and the PSNR of the world's mean squared
    error, as the one-process step takes it over the joined batch."""
    names = sorted(k for k in metrics if k != "psnr")
    values = torch.stack([metrics[k].to(target_mse.dtype).reshape(()) for k in names] + [target_mse])
    all_reduce_mean_([values], mesh, name="metrics")
    out = dict(zip(names, values[:-1]))
    out["render_overflow"] = out["render_overflow"] * mesh.world
    out["psnr"] = -10.0 * torch.log10(values[-1:] + 1e-12)
    return out


def make_train_step(
    encoder_cfg: EncoderCfg,
    loss_cfg: LossCfg,
    decoder_cfg: DecoderCfg,
    optimizer: ClipAdam,
    image_shape: tuple[int, int],
    deterministic: bool = False,
    deterministic_kernels: bool = False,
    mesh=None,
):
    """Returns train_step(state, batch, generator) -> (state, metrics).

    batch: {"context": image, intrinsics, extrinsics, near, far;
    "target": the same} as tensors on the encoder's device. `generator`
    (on that device) draws the dropout masks; `deterministic` turns dropout
    off (BatchNorm stays on batch statistics); `deterministic_kernels` gives
    the same bits on every run (the module docstring). The state is updated in
    place. Metrics are 0-dim tensors (lr a float), so a step does not wait
    for the card: loss, mse, lpips, psnr, grad_norm, lr, render_overflow
    (always 0: the port drops nothing).

    mesh (parallel/mesh.py): every rank calls the step with its own batch
    (its dp slice; the ranks of one sp group the same batch), the same state
    and a generator seeded alike within a dp group (Trainer._step_generator),
    so that the ranks of a dp group compute one encoder forward. Each keeps
    its slice of the Gaussians, the decode gathers them and renders the
    rank's views, and the rank's loss L_r is the mean over its views. The
    JAX step's loss under GSPMD is the mean over the global batch and views,
    L = (1 / W) sum_r L_r over the W ranks (every shard the same size). Each
    rank differentiates its own L_r with its own copy of the parameters;
    the collectives' backwards are their adjoints (the gather's a
    reduce-scatter over sp, BatchNorm's all-reduce an all-reduce over dp),
    so rank r's gradient is d(sum_r' L_r') / d(theta_r), the world loss's
    derivative through rank r's copy. Summed over the ranks that is
    d(sum_r L_r) / d(theta) at equal copies, and the mean over the world
    is dL / d(theta): the gradient of the JAX step. It is all-reduced before
    the clip, so the clip and `grad_norm` see the global gradient as JAX's
    do. The metrics are the world's (`_world_metrics`)."""

    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None = None):
        if state.encoder.cfg != encoder_cfg:
            raise ValueError("the state's encoder was built from another EncoderCfg")
        metrics, grads = loss_and_grads(
            state, batch, loss_cfg, decoder_cfg, image_shape, generator, deterministic, deterministic_kernels, mesh
        )
        if mesh is not None:
            with span("train.all_reduce"):
                all_reduce_mean_(list(grads.values()), mesh, name="gradients")
                metrics = _world_metrics(metrics, metrics.pop("psnr_mse"), mesh)
        with span("train.optimizer"):
            metrics["grad_norm"] = optimizer.update(state.trainable(), grads, state.opt_state)
        metrics["lr"] = optimizer.lr_schedule(state.step)
        state.step += 1
        return state, metrics

    return train_step
