"""DINO vision transformers (inference only): the frozen DAv2 prior's DINOv2
and pixelSplat's DINO ViT-B/8.

Counterpart of transplat_tpu/model/dav2/vit.py: patch-14 ViT with layer
scale, pre-norm blocks, bicubic-interpolated position embeddings (with the
DINO +0.1 scale_factor quirk) and intermediate-layer extraction. The patch
size, the pretraining size (the position table's side) and the layer scale
are options: DINO v1's ViT-B/8 (model/encoder_epipolar.py) has patch 8, a
28 x 28 table and no layer scale, and reads the final norm of every token
(`final_tokens`).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops.interpolate import resize_bicubic_torch
from ..layers import gelu, layer_norm, to_nchw


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        head = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, head)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (b, heads, n, head)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / (head**0.5), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4, layer_scale: bool = True):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim) if layer_scale else nn.Identity()
        self.norm2 = layer_norm(dim)
        self.mlp_fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.mlp_fc2 = nn.Linear(dim * mlp_ratio, dim)
        self.ls2 = LayerScale(dim) if layer_scale else nn.Identity()

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x)))))


class DinoVisionTransformer(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12, patch_size: int = 14,
                 pretrain_img_size: int = 518, layer_scale: bool = True):
        super().__init__()
        self.embed_dim = embed_dim
        self.depth = depth
        self.patch_size = patch_size
        self.side = pretrain_img_size // patch_size
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.side * self.side + 1, embed_dim))
        for i in range(depth):
            self.add_module(f"block_{i}", Block(embed_dim, num_heads, layer_scale=layer_scale))
        self.norm = layer_norm(embed_dim)

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) -> the first block's input (B, 1 + N_patches, C): the
        class token, then the patches, each with its position."""
        b, h, w, _ = x.shape
        ph, pw = h // self.patch_size, w // self.patch_size
        e = self.embed_dim
        tokens = self.patch_embed(to_nchw(x)).flatten(2).transpose(1, 2)  # (B, ph*pw, E)
        side = self.side
        patch_pos = self.pos_embed[:, 1:]
        if (ph, pw) != (side, side):
            patch_pos = resize_bicubic_torch(
                patch_pos.reshape(1, side, side, e), (ph, pw), scale=((ph + 0.1) / side, (pw + 0.1) / side)
            ).reshape(1, ph * pw, e)
        tokens = tokens + patch_pos
        cls_tok = (self.cls_token + self.pos_embed[:, :1]).expand(b, 1, e)
        return torch.cat([cls_tok, tokens], dim=1)

    def forward(self, x: torch.Tensor, take_layers: Sequence[int] = (2, 5, 8, 11)):
        """x (B, H, W, 3) normalized -> list of (B, N_patches, C) token maps
        (final norm applied, cls token dropped), one per requested block."""
        tokens = self.tokens(x)
        outputs = {}
        for i in range(self.depth):
            tokens = getattr(self, f"block_{i}")(tokens)
            if i in take_layers:
                outputs[i] = tokens
        return [self.norm(outputs[i])[:, 1:] for i in take_layers]

    def final_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) -> the final norm of the last block's tokens (B, 1 +
        N_patches, C), class token first (DINO's get_intermediate_layers(x, 1))."""
        tokens = self.tokens(x)
        for i in range(self.depth):
            tokens = getattr(self, f"block_{i}")(tokens)
        return self.norm(tokens)
