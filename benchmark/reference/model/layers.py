"""Shared building blocks.

Counterpart of transplat_tpu/model/layers.py. Convolutions run NCHW; module
and attribute names follow the Flax modules so weights map mechanically
(convert.load_jax_variables). Norm epsilons are the Flax ones: LayerNorm
and a plain GroupNorm 1e-6, the U-Net `group_norm` 1e-5, BatchNorm 1e-5.

Modules honour train() / eval(). Dropout masks are drawn from a
`torch.Generator` the caller hands down, never from the global RNG.

`Conv2d`, `Linear` and `GroupNorm` carry Flax's per-module compute dtype
(`compute_dtype`, the Flax modules' `dtype`): the parameters stay float32
and are cast inside forward, so the optimiser and convert.load_jax_variables
see float32 leaves. The casts are explicit, where Flax puts them, not
torch.autocast's: autocast keeps GroupNorm's output in float32, Flax's
GroupNorm(dtype=bfloat16) returns bfloat16.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

LN_EPS = 1e-6  # flax.linen.LayerNorm / GroupNorm default


class Conv2d(nn.Conv2d):
    """nn.Conv2d with flax.linen.Conv's `dtype`. None: the input and the
    parameters promoted to one type (a bfloat16 input meets float32
    parameters in float32). A dtype: input, kernel and bias cast to it, the
    bias added after the convolution, the result in that dtype."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.at(x, self.compute_dtype)

    def at(self, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
        """The convolution computed in `dtype` (None: promoted)."""
        if dtype is None:
            return super().forward(x.to(torch.promote_types(x.dtype, self.weight.dtype)))
        y = self._conv_forward(x.to(dtype), self.weight.to(dtype), None)
        return y if self.bias is None else y + self.bias.to(dtype).view(1, -1, 1, 1)


class Linear(nn.Linear):
    """nn.Linear with flax.linen.Dense's `dtype` (as Conv2d)."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x.to(torch.promote_types(x.dtype, self.weight.dtype)))
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm as flax.linen.GroupNorm computes it: statistics and
    normalisation in at least float32 (`force_float32_reductions`), the
    result cast to `compute_dtype` (None: the type it was computed in)."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(torch.promote_types(x.dtype, torch.float32), self.weight.dtype)
        y = F.group_norm(x.to(dt), self.num_groups, self.weight.to(dt), self.bias.to(dt), self.eps)
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


def conv(cin: int, cout: int, kernel: int = 3, stride: int = 1, bias: bool = True,
         dtype: torch.dtype | None = None) -> Conv2d:
    """Conv with torch "padding = (k - 1) // 2" semantics (the JAX `conv`);
    `dtype` its compute dtype."""
    return Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=bias, compute_dtype=dtype)


def layer_norm(channels: int) -> nn.LayerNorm:
    return nn.LayerNorm(channels, eps=LN_EPS)


def group_norm(channels: int, dtype: torch.dtype | None = None) -> GroupNorm:
    """The LDM-UNet normalization: GN(8) if divisible else GN(4), eps 1e-5;
    float32 statistics, the result in `dtype` (None: float32)."""
    return GroupNorm(8 if channels % 8 == 0 else 4, channels, eps=1e-5, compute_dtype=dtype)


def checkpointed(fn, *args, replay: torch.Generator | None = None):
    """fn(*args) under gradient checkpointing (torch.utils.checkpoint,
    non-reentrant): its activations are dropped after the forward and
    recomputed in the backward, as flax.linen.remat does. checkpoint keeps
    only the global generators' states, and the regions the port checkpoints
    draw from none of them (preserve_rng_state off). They draw their dropout
    masks from `replay`: the recomputation starts it from its state at the
    forward's entry, so it draws the forward's masks again, and puts it back
    where the backward found it, so that it stands where a forward without
    checkpointing leaves it."""
    from torch.utils.checkpoint import checkpoint

    entry = None if replay is None else replay.get_state()
    first = True

    def run(*a):
        nonlocal first
        if first or entry is None:
            first = False
            return fn(*a)
        now = replay.get_state()
        replay.set_state(entry)
        try:
            return fn(*a)
        finally:
            replay.set_state(now)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on (N, C, H, W)."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = x.var(dim=(-2, -1), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or in its own type where that is wider (float64 runs):
    the JAX model's `.astype(jnp.float32)` on a bfloat16 or float32 value."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU. In bfloat16 it is jax.nn.gelu's expression op by op,
    0.5 x erfc(-x sqrt(1/2)) with sqrt(1/2) in bfloat16, so that it rounds
    where the JAX model's rounds; otherwise PyTorch's fused GELU."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="none")
    sqrt_half = torch.tensor(0.5**0.5, dtype=x.dtype)  # a CPU scalar, as an operand of a card tensor too
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU. In bfloat16 it is jax.nn.silu as XLA evaluates it, x * (1 / (1 +
    exp(-x))), each op rounded to bfloat16 as in the JAX model (PyTorch's
    sigmoid rounds once and gives other bits in a third of the values);
    otherwise PyTorch's fused SiLU."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Dropout(nn.Module):
    """Inverted dropout (flax.linen.Dropout): in training each value is kept
    with probability 1 - rate and scaled by 1 / (1 - rate); the mask is drawn
    from `generator` (on the tensor's device). Identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} not in [0, 1)")
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training mode needs a torch.Generator")
        keep = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) >= self.rate
        return x * keep / (1.0 - self.rate)


class _FlaxBatchNorm:
    """Training-mode forward of flax.linen.BatchNorm(momentum=0.9), which is
    PyTorch's momentum 0.1: normalise with the batch's mean and biased
    variance and move the running statistics a tenth of the way to them.
    (PyTorch's own update feeds the unbiased variance to the running one;
    Flax feeds the biased one, and the port follows Flax.)"""

    batch_stats = None  # (mean, biased variance) of the latest training forward, detached

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0, *range(2, x.ndim)]
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, unbiased=False)
        self.batch_stats = (mean.detach(), var.detach())
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class Mlp(nn.Module):
    """2-layer ReLU MLP."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(cin, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class FFN(nn.Module):
    """Residual feed-forward with dropout after the activation and after fc2."""

    def __init__(self, embed_dims: int = 128, feedforward: int = 256, dropout: float = 0.1):
        super().__init__()
        self.fc1 = nn.Linear(embed_dims, feedforward)
        self.fc2 = nn.Linear(feedforward, embed_dims)
        self.dropout = Dropout(dropout)

    def forward(self, x, generator: torch.Generator | None = None):
        h = self.dropout(F.relu(self.fc1(x)), generator)
        return x + self.dropout(self.fc2(h), generator)


class SELayer(nn.Module):
    """Squeeze-excite gate: x (N, C, H, W) * sigmoid(MLP(x_se (N, C, 1, 1)))."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = conv(channels, channels, 1)
        self.conv_expand = conv(channels, channels, 1)

    def forward(self, x, x_se):
        return x * torch.sigmoid(self.conv_expand(F.relu(self.conv_reduce(x_se))))
