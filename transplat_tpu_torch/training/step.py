"""Training step: forward (encoder -> decoder -> losses), backward, clip + Adam.

Counterpart of transplat_tpu/training/step.py on a single device: the JAX
`mesh`, `constrain` and `donate` arguments have no counterpart yet. The
encoder module holds the parameters and the BatchNorm statistics, and the
step updates them in place. On the card the gradients of the deformable
sampler and of the rasterizer come from the hand-written backward kernels
(ops/deform.py, ops/rasterizer/composite.py); everything else is autograd.
The stages of a step are marked with record_function spans (`train.*`),
which profile_training.py reads.

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
from torch.profiler import record_function

from ..loss.losses import LossCfg, compute_losses
from ..loss.vgg import LPIPS
from ..model.decoder import DecoderCfg, decode_splatting
from ..model.encoder import EncoderCfg, EncoderTranSplat
from ..dataset.loader import CONTEXT_KEYS
from ..evaluation.metrics import compute_psnr
from ..model.init import init_parameters
from ..model.layers import Dropout


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
    encoder: EncoderTranSplat  # parameters and BatchNorm statistics
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
) -> TrainState:
    """A fresh state on `device`: a new EncoderTranSplat, step 0, zero Adam
    moments. With a `seed` the parameters are drawn as the JAX package's
    initialisers draw them (model/init.py), for training from scratch;
    without one they keep PyTorch's default initialisation, for a caller who
    loads or draws the weights afterwards."""
    state = TrainState(step=0, encoder=EncoderTranSplat(encoder_cfg, device=device), lpips=lpips, opt_state=AdamState())
    if seed is not None:
        init_parameters(state.encoder, seed)
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


def loss_and_grads(
    state: TrainState,
    batch: dict,
    loss_cfg: LossCfg,
    decoder_cfg: DecoderCfg,
    image_shape: tuple[int, int],
    generator: torch.Generator | None = None,
    deterministic: bool = False,
    deterministic_kernels: bool = False,
):
    """One forward and backward of the training loss in training mode (batch
    statistics in BatchNorm, which move their running ones; dropout from
    `generator` unless `deterministic`; with `deterministic_kernels` the
    same bits on every run, see the module docstring). Returns (metrics,
    gradients by parameter name), the loss under metrics["loss"]; the encoder
    is back in eval mode afterwards."""
    encoder = state.encoder
    params = state.trainable()
    encoder.train()
    for m in encoder.modules():
        if isinstance(m, Dropout):
            m.train(not deterministic)
    try:
        ctx, tgt = batch["context"], batch["target"]
        with repeatable_ops(deterministic_kernels):
            with record_function("train.encoder"):
                gaussians = encoder(
                    *(ctx[k] for k in CONTEXT_KEYS), global_step=state.step, generator=generator,
                    deterministic_kernels=deterministic_kernels,
                )
            with record_function("train.decoder"):
                out = decode_splatting(
                    gaussians, tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"], image_shape,
                    cfg=decoder_cfg, deterministic_kernels=deterministic_kernels,
                )
            with record_function("train.loss"):
                loss, parts = compute_losses(loss_cfg, out.color, tgt["image"], state.step, lpips_fn=state.lpips)
            with record_function("train.backward"):
                grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    finally:
        encoder.eval()
    metrics = {k: v.detach() for k, v in parts.items()}
    with torch.no_grad():
        metrics["loss"] = loss.detach()
        metrics["render_overflow"] = out.overflow.sum().to(torch.float32)
        # One PSNR over the whole batch (every view in one mean), as the JAX step reports it.
        metrics["psnr"] = compute_psnr(tgt["image"].reshape(1, -1, 3), out.color.reshape(1, -1, 3))
    # A parameter the loss does not reach has gradient 0, as in JAX.
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
    return metrics, grads


def make_train_step(
    encoder_cfg: EncoderCfg,
    loss_cfg: LossCfg,
    decoder_cfg: DecoderCfg,
    optimizer: ClipAdam,
    image_shape: tuple[int, int],
    deterministic: bool = False,
    deterministic_kernels: bool = False,
):
    """Returns train_step(state, batch, generator) -> (state, metrics).

    batch: {"context": image, intrinsics, extrinsics, near, far;
    "target": the same} as tensors on the encoder's device. `generator`
    (on that device) draws the dropout masks; `deterministic` turns dropout
    off (BatchNorm stays on batch statistics); `deterministic_kernels` gives
    the same bits on every run (the module docstring). The state is updated in
    place. Metrics are 0-dim tensors (lr a float), so a step does not wait
    for the card: loss, mse, lpips, psnr, grad_norm, lr, render_overflow
    (always 0: the port drops nothing)."""

    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None = None):
        if state.encoder.cfg != encoder_cfg:
            raise ValueError("the state's encoder was built from another EncoderCfg")
        metrics, grads = loss_and_grads(
            state, batch, loss_cfg, decoder_cfg, image_shape, generator, deterministic, deterministic_kernels
        )
        with record_function("train.optimizer"):
            metrics["grad_norm"] = optimizer.update(state.trainable(), grads, state.opt_state)
        metrics["lr"] = optimizer.lr_schedule(state.step)
        state.step += 1
        return state, metrics

    return train_step
