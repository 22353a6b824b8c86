"""Depth-aware deformable attention ("UV transformer"), the cost-volume core.

Counterpart of transplat_tpu/model/uv_transformer.py. The coarse and cross
attentions reduce sampled value vectors against the query pixel's own key,
so the channel reduction is hoisted into one matmul S = K V^T and scalars
are bilinearly sampled from S (ops/deform.py, kernels K5 / K6). The
self-attention samples value vectors themselves (`deform_sample_vectors`,
kernels K7 / K8 on the card). The query's channels double as the
depth-candidate slots.

Every tensor carries a leading pair dim (N, ...): the JAX package vmaps
UVMatcher over directed view pairs; here the pair dim is written out.
Dropout (rate 0.1) sits where the Flax modules have it: on the outputs of
the self- and cross-attention and twice in the FFN. `deterministic_kernels`
makes the samplers' backward kernels repeat their bits from run to run (K8's
sorted mode; K6 refuses a shape it cannot sum in a fixed order).

The matcher runs in float32 under every compute dtype (the JAX
DepthPredictor gives it none). `remat` checkpoints each fine layer, as the
JAX matcher's `nn.remat(UVFineLayer)`: the backward runs the layer's
forward again, K7 and K5 (P = 4) included, with the forward's dropout masks
(layers.checkpointed).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.deform import deform_sample_scores, deform_sample_vectors
from ..utils.constants import device_constant
from .layers import FFN, Dropout, checkpointed, layer_norm


def coarse_correlation(key_feat, value_feat, grid, hw: tuple[int, int], deterministic_kernels: bool = False):
    """key_feat (N, Q, C), value_feat (N, HW, C), grid (N, Q, D, 2) -> (N, Q, D):
    sum_c V[loc]_c K_c / sqrt(C) (plane-sweep correlation)."""
    c = key_feat.shape[-1]
    scores = torch.matmul(key_feat, value_feat.transpose(-1, -2)) / (c**0.5)
    weights = torch.ones(grid.shape[:-1] + (1,), dtype=key_feat.dtype, device=key_feat.device)
    return deform_sample_scores(scores, hw, grid[..., None, :], weights, deterministic=deterministic_kernels)


class UVSelfAttention(nn.Module):
    """Deformable self-attention over the query map (P points)."""

    def __init__(self, embed_dims: int = 128, num_points: int = 4, dropout: float = 0.1):
        super().__init__()
        self.num_points = num_points
        self.dropout = Dropout(dropout)
        self.sampling_offsets = nn.Linear(embed_dims, num_points * 2)
        self.attention_weights = nn.Linear(embed_dims, num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query, query_pos, ref_2d, hw, generator=None, deterministic_kernels=False):
        """query (N, Q, C); query_pos (N, Q, C) or None; ref_2d (N, Q, 2) in [0, 1]."""
        q_in = query if query_pos is None else query + query_pos
        p = self.num_points
        offsets = self.sampling_offsets(q_in).reshape(*q_in.shape[:-1], p, 2)
        weights = torch.softmax(self.attention_weights(q_in), dim=-1)
        value = self.value_proj(query)
        h, w = hw
        norm = device_constant((w, h), q_in)
        loc = ref_2d[..., None, :] + offsets / norm
        out = deform_sample_vectors(value, hw, loc, weights, deterministic=deterministic_kernels)  # K7; backward K8
        return self.dropout(self.output_proj(out), generator) + query


class UVCrossAttention(nn.Module):
    """Depth-aware deformable cross-attention (learned offsets per depth)."""

    def __init__(self, embed_dims: int = 128, num_depth: int = 128, num_points: int = 4, dropout: float = 0.1):
        super().__init__()
        self.num_depth, self.num_points, self.embed_dims = num_depth, num_points, embed_dims
        self.dropout = Dropout(dropout)
        self.sampling_offsets = nn.Linear(embed_dims, num_depth * num_points * 2)
        self.attention_weights = nn.Linear(embed_dims, num_depth * num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(num_depth, embed_dims)

    def forward(self, query, key_feat, value_feat, grid, hw, generator=None, deterministic_kernels=False):
        """query/key_feat (N, Q, C); value_feat (N, HW, C); grid (N, Q, D, 2)."""
        d, p, c = self.num_depth, self.num_points, self.embed_dims
        offsets = self.sampling_offsets(query).reshape(*query.shape[:-1], d, p, 2)
        weights = torch.softmax(self.attention_weights(query).reshape(*query.shape[:-1], d, p), dim=-1)
        value = self.value_proj(value_feat)
        scores = torch.matmul(key_feat, value.transpose(-1, -2)) / c  # mean over channels
        h, w = hw
        norm = device_constant((w, h), query)
        loc = grid[..., None, :] + offsets / norm
        corr = deform_sample_scores(scores, hw, loc, weights, deterministic=deterministic_kernels)  # (N, Q, D)
        return self.dropout(self.output_proj(corr), generator) + query


class UVFineLayer(nn.Module):
    """Self-attn -> cross-attn -> FFN with LayerNorms."""

    def __init__(self, embed_dims: int = 128, num_depth: int = 128):
        super().__init__()
        self.self_attn = UVSelfAttention(embed_dims)
        self.norm0 = layer_norm(embed_dims)
        self.cross_attn = UVCrossAttention(embed_dims, num_depth)
        self.norm1 = layer_norm(embed_dims)
        self.ffn = FFN(embed_dims, 256)
        self.norm2 = layer_norm(embed_dims)

    def forward(self, query, bev_pos, key_feat, value_feat, grid, ref_2d, hw, generator=None, deterministic_kernels=False):
        query = self.norm0(self.self_attn(query, bev_pos, ref_2d, hw, generator, deterministic_kernels))
        query = self.norm1(self.cross_attn(query, key_feat, value_feat, grid, hw, generator, deterministic_kernels))
        return self.norm2(self.ffn(query, generator))


class UVMatcher(nn.Module):
    """Coarse + fine matching for directed view pairs."""

    def __init__(self, embed_dims: int = 128, num_depth: int = 128, num_fine_layers: int = 2, remat: bool = False):
        super().__init__()
        if num_depth != embed_dims:
            raise ValueError("num_depth must equal embed_dims (the query channels are the depth slots)")
        self.num_fine_layers = num_fine_layers
        self.remat = remat
        for i in range(num_fine_layers):
            self.add_module(f"fine_{i}", UVFineLayer(embed_dims, num_depth))

    def forward(self, key_feat, value_feat, bev_pos, grid, ref_2d, hw, generator=None, deterministic_kernels=False):
        """key_feat (N, Q, C); value_feat (N, HW, C); bev_pos (N, Q, C);
        grid (N, Q, D, 2); ref_2d (N, Q, 2); generator: the dropout masks'
        source in training mode; deterministic_kernels: backward kernels that
        repeat their bits. Returns (N, Q, C)."""
        query = coarse_correlation(key_feat, value_feat, grid, hw, deterministic_kernels)
        for i in range(self.num_fine_layers):
            layer = getattr(self, f"fine_{i}")
            args = (query, bev_pos, key_feat, value_feat, grid, ref_2d, hw, generator, deterministic_kernels)
            if self.remat and torch.is_grad_enabled():
                query = checkpointed(layer, *args, replay=generator)
            else:
                query = layer(*args)
        return query
