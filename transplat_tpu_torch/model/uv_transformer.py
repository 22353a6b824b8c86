"""Depth-aware deformable attention ("UV transformer"), the cost-volume core.

Counterpart of transplat_tpu/model/uv_transformer.py. The coarse and cross
attentions reduce sampled value vectors against the query pixel's own key,
so the channel reduction is hoisted into one matmul S = K V^T and scalars
are bilinearly sampled from S (ops/deform.py, kernel K5). The query's
channels double as the depth-candidate slots.

Every tensor carries a leading pair dim (N, ...): the JAX package vmaps
UVMatcher over directed view pairs; here the pair dim is written out.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.deform import deform_sample_scores, deform_sample_vectors
from .layers import FFN, layer_norm


def coarse_correlation(key_feat, value_feat, grid, hw: tuple[int, int]) -> torch.Tensor:
    """key_feat (N, Q, C), value_feat (N, HW, C), grid (N, Q, D, 2) -> (N, Q, D):
    sum_c V[loc]_c K_c / sqrt(C) (plane-sweep correlation)."""
    c = key_feat.shape[-1]
    scores = torch.matmul(key_feat, value_feat.transpose(-1, -2)) / (c**0.5)
    weights = torch.ones(grid.shape[:-1] + (1,), dtype=key_feat.dtype, device=key_feat.device)
    return deform_sample_scores(scores, hw, grid[..., None, :], weights)


class UVSelfAttention(nn.Module):
    """Deformable self-attention over the query map (P points)."""

    def __init__(self, embed_dims: int = 128, num_points: int = 4):
        super().__init__()
        self.num_points = num_points
        self.sampling_offsets = nn.Linear(embed_dims, num_points * 2)
        self.attention_weights = nn.Linear(embed_dims, num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query, query_pos, ref_2d, hw):
        """query (N, Q, C); query_pos (N, Q, C) or None; ref_2d (N, Q, 2) in [0, 1]."""
        q_in = query if query_pos is None else query + query_pos
        p = self.num_points
        offsets = self.sampling_offsets(q_in).reshape(*q_in.shape[:-1], p, 2)
        weights = torch.softmax(self.attention_weights(q_in), dim=-1)
        value = self.value_proj(query)
        h, w = hw
        norm = torch.tensor([w, h], dtype=q_in.dtype, device=q_in.device)
        loc = ref_2d[..., None, :] + offsets / norm
        out = deform_sample_vectors(value, hw, loc, weights)
        return self.output_proj(out) + query


class UVCrossAttention(nn.Module):
    """Depth-aware deformable cross-attention (learned offsets per depth)."""

    def __init__(self, embed_dims: int = 128, num_depth: int = 128, num_points: int = 4):
        super().__init__()
        self.num_depth, self.num_points, self.embed_dims = num_depth, num_points, embed_dims
        self.sampling_offsets = nn.Linear(embed_dims, num_depth * num_points * 2)
        self.attention_weights = nn.Linear(embed_dims, num_depth * num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(num_depth, embed_dims)

    def forward(self, query, key_feat, value_feat, grid, hw):
        """query/key_feat (N, Q, C); value_feat (N, HW, C); grid (N, Q, D, 2)."""
        d, p, c = self.num_depth, self.num_points, self.embed_dims
        offsets = self.sampling_offsets(query).reshape(*query.shape[:-1], d, p, 2)
        weights = torch.softmax(self.attention_weights(query).reshape(*query.shape[:-1], d, p), dim=-1)
        value = self.value_proj(value_feat)
        scores = torch.matmul(key_feat, value.transpose(-1, -2)) / c  # mean over channels
        h, w = hw
        norm = torch.tensor([w, h], dtype=query.dtype, device=query.device)
        loc = grid[..., None, :] + offsets / norm
        corr = deform_sample_scores(scores, hw, loc, weights)  # (N, Q, D)
        return self.output_proj(corr) + query


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

    def forward(self, query, bev_pos, key_feat, value_feat, grid, ref_2d, hw):
        query = self.norm0(self.self_attn(query, bev_pos, ref_2d, hw))
        query = self.norm1(self.cross_attn(query, key_feat, value_feat, grid, hw))
        return self.norm2(self.ffn(query))


class UVMatcher(nn.Module):
    """Coarse + fine matching for directed view pairs."""

    def __init__(self, embed_dims: int = 128, num_depth: int = 128, num_fine_layers: int = 2):
        super().__init__()
        if num_depth != embed_dims:
            raise ValueError("num_depth must equal embed_dims (the query channels are the depth slots)")
        self.num_fine_layers = num_fine_layers
        for i in range(num_fine_layers):
            self.add_module(f"fine_{i}", UVFineLayer(embed_dims, num_depth))

    def forward(self, key_feat, value_feat, bev_pos, grid, ref_2d, hw):
        """key_feat (N, Q, C); value_feat (N, HW, C); bev_pos (N, Q, C);
        grid (N, Q, D, 2); ref_2d (N, Q, 2). Returns (N, Q, C)."""
        query = coarse_correlation(key_feat, value_feat, grid, hw)
        for i in range(self.num_fine_layers):
            query = getattr(self, f"fine_{i}")(query, bev_pos, key_feat, value_feat, grid, ref_2d, hw)
        return query
