"""LDM-style 2D U-Net with cross-view self-attention (no timestep embedding).

Counterpart of transplat_tpu/model/unet.py, plain path, NCHW. The JAX
package's space-to-depth tower (s2d=True) computes the same function with the
same parameters, so the port has only this path.

`dtype` is the Flax modules' compute dtype (None: float32): convolutions,
dense layers and the GroupNorms' results in it, the attention's softmax in
float32, and the final GroupNorm and SiLU in float32 whatever it is (the
JAX `out_norm` takes no dtype). `remat` checkpoints the whole U-Net, as
`nn.remat(UNetModel)` does: its activations are recomputed in the backward.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.interpolate import upsample_nearest_nchw
from .layers import Linear, checkpointed, conv, group_norm, silu


class ResBlock(nn.Module):
    """Postnorm residual block."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.in_conv = conv(cin, cout, 3, dtype=dtype)
        self.in_norm = group_norm(cout, dtype)
        self.out_conv = conv(cout, cout, 3, dtype=dtype)
        self.out_norm = group_norm(cout, dtype)
        self.skip = conv(cin, cout, 1, dtype=dtype) if cin != cout else None

    def forward(self, x):
        h = silu(self.in_norm(self.in_conv(x)))
        h = silu(self.out_norm(self.out_conv(h)))
        if self.skip is not None:
            x = self.skip(x)
        return (x + h).to(self.dtype or x.dtype)


class AttentionBlock(nn.Module):
    """Self-attention over spatial tokens of all views jointly; postnorm
    (qkv -> attention -> proj -> GN, residual)."""

    def __init__(self, channels: int, num_head_channels: int = 32, num_frames: int = 2, cross_view: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.heads = max(1, channels // num_head_channels)
        self.num_frames = num_frames
        self.cross_view = cross_view
        self.dtype = dtype
        self.qkv = Linear(channels, 3 * channels, compute_dtype=dtype)
        self.proj_out = Linear(channels, channels, compute_dtype=dtype)
        self.norm = group_norm(channels, dtype)

    def forward(self, x):
        n, c, h, w = x.shape
        t = h * w
        heads = self.heads
        qkv = self.qkv(x.flatten(2).transpose(1, 2))  # (n, t, 3c)
        if self.cross_view:
            qkv = qkv.reshape(n // self.num_frames, self.num_frames * t, 3 * c)
        bs, length, _ = qkv.shape
        qkv = qkv.reshape(bs, length, heads, 3, c // heads)
        q, k, v = (qkv[..., i, :].transpose(1, 2) for i in range(3))  # (bs, heads, L, ch)
        # The scale in the compute dtype, as JAX's weakly typed constant is.
        scale = torch.tensor(1.0 / ((c // heads) ** 0.25), dtype=q.dtype)
        weight = torch.matmul(q * scale, (k * scale).transpose(-1, -2))
        weight = torch.softmax(weight.to(torch.float32), dim=-1).to(q.dtype)
        out = torch.matmul(weight, v).transpose(1, 2).reshape(bs, length, c)
        out = out.reshape(n, t, c)
        out = self.norm(self.proj_out(out).transpose(1, 2))  # GN over (n, c, t)
        return (x + out.reshape(n, c, h, w)).to(self.dtype or x.dtype)


class UNetModel(nn.Module):
    def __init__(
        self,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int = 1,
        attention_resolutions: Sequence[int] = (),
        channel_mult: Sequence[int] = (1, 1, 1),
        num_head_channels: int = 32,
        num_frames: int = 2,
        cross_view: bool = True,
        dtype: torch.dtype | None = None,
        remat: bool = False,
    ):
        super().__init__()
        mc = model_channels
        attn_res = set(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.num_res_blocks = num_res_blocks
        self.remat = remat

        def attn(ch, ds, name):
            if ds in attn_res:
                self.add_module(name, AttentionBlock(ch, num_head_channels, num_frames, cross_view, dtype))

        self.in_conv = conv(in_channels, mc, 3, dtype=dtype)
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                self.add_module(f"down_{level}_{i}", ResBlock(ch, mult * mc, dtype))
                ch = mult * mc
                attn(ch, ds, f"down_{level}_{i}_attn")
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.add_module(f"downsample_{level}", conv(ch, ch, 3, stride=2, dtype=dtype))
                chans.append(ch)
                ds *= 2
        self.middle_0 = ResBlock(ch, ch, dtype)
        self.middle_1 = ResBlock(ch, ch, dtype)
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                self.add_module(f"up_{level}_{i}", ResBlock(ch + chans.pop(), mult * mc, dtype))
                ch = mult * mc
                attn(ch, ds, f"up_{level}_{i}_attn")
                if level and i == num_res_blocks:
                    self.add_module(f"upsample_{level}", conv(ch, ch, 3, dtype=dtype))
                    ds //= 2
        self.out_conv = conv(ch, out_channels, 3, dtype=dtype)
        self.out_norm = group_norm(out_channels)  # float32 whatever `dtype` is, as in JAX

    def _attn(self, h, name):
        block = getattr(self, name, None)
        return h if block is None else block(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, C_in, H, W) with N = b * num_frames; float32 out."""
        if self.remat and torch.is_grad_enabled():
            return checkpointed(self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        hs = []
        h = self.in_conv(x)
        hs.append(h)
        for level, _ in enumerate(self.channel_mult):
            for i in range(self.num_res_blocks):
                h = getattr(self, f"down_{level}_{i}")(h)
                h = self._attn(h, f"down_{level}_{i}_attn")
                hs.append(h)
            if level != len(self.channel_mult) - 1:
                h = getattr(self, f"downsample_{level}")(h)
                hs.append(h)
        h = self.middle_1(self.middle_0(h))
        for level, _ in reversed(list(enumerate(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_{i}")(torch.cat([h, hs.pop()], dim=1))
                h = self._attn(h, f"up_{level}_{i}_attn")
                if level and i == self.num_res_blocks:
                    h = getattr(self, f"upsample_{level}")(upsample_nearest_nchw(h, 2))
        return silu(self.out_norm(self.out_conv(h)))
