"""Multi-view Swin-window feature transformer, counterpart of
transplat_tpu/model/backbone/transformer.py: per layer, windowed
self-attention, windowed cross-attention against the other views, and a GELU
FFN on [source || message]; shifted windows on odd layers; one head."""

from __future__ import annotations

import torch
from torch import nn

from ...ops.window import window_attention
from ..layers import gelu, layer_norm


class TransformerLayer(nn.Module):
    def __init__(self, d_model: int = 128, no_ffn: bool = False, ffn_dim_expansion: int = 4, with_shift: bool = False):
        super().__init__()
        c = d_model
        self.with_shift = with_shift
        self.q_proj = nn.Linear(c, c, bias=False)
        self.k_proj = nn.Linear(c, c, bias=False)
        self.v_proj = nn.Linear(c, c, bias=False)
        self.merge = nn.Linear(c, c, bias=False)
        self.norm1 = layer_norm(c)
        self.no_ffn = no_ffn
        if not no_ffn:
            self.mlp_0 = nn.Linear(2 * c, 2 * c * ffn_dim_expansion, bias=False)
            self.mlp_2 = nn.Linear(2 * c * ffn_dim_expansion, c, bias=False)
            self.norm2 = layer_norm(c)

    def forward(self, source, target, h: int, w: int, splits: int):
        """source: (N, L, C); target: (N, L, C) self or (N, M, L, C) cross."""
        message = window_attention(
            self.q_proj(source), self.k_proj(target), self.v_proj(target), h, w, splits, self.with_shift
        )
        message = self.norm1(self.merge(message))
        if not self.no_ffn:
            hcat = gelu(self.mlp_0(torch.cat([source, message], dim=-1)))
            message = self.norm2(self.mlp_2(hcat))
        return source + message


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int = 128, ffn_dim_expansion: int = 4, with_shift: bool = False):
        super().__init__()
        self.self_attn = TransformerLayer(d_model, no_ffn=True, with_shift=with_shift)
        self.cross_attn_ffn = TransformerLayer(d_model, ffn_dim_expansion=ffn_dim_expansion, with_shift=with_shift)

    def forward(self, source, target, h, w, splits):
        source = self.self_attn(source, source, h, w, splits)
        return self.cross_attn_ffn(source, target, h, w, splits)


class MultiViewFeatureTransformer(nn.Module):
    def __init__(self, num_layers: int = 6, d_model: int = 128, ffn_dim_expansion: int = 4):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerBlock(d_model, ffn_dim_expansion, with_shift=(i % 2 == 1)))

    def forward(self, features: torch.Tensor, splits: int = 2) -> torch.Tensor:
        """features: (B, V, H, W, C) -> (B, V, H, W, C)."""
        b, v, h, w, c = features.shape
        tokens = features.reshape(b, v, h * w, c)
        for i in range(self.num_layers):
            others = [torch.stack([tokens[:, j] for j in range(v) if j != vi], dim=1) for vi in range(v)]
            q = tokens.reshape(b * v, h * w, c)
            kv = torch.stack(others, dim=1).reshape(b * v, v - 1, h * w, c)
            q = getattr(self, f"layer_{i}")(q, kv, h, w, splits)
            tokens = q.reshape(b, v, h * w, c)
        return tokens.reshape(b, v, h, w, c)
