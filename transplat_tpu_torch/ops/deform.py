"""Deformable-attention sampling primitives.

Counterpart of transplat_tpu/ops/deform.py. Sampling conventions are mmcv's:
locations in [0, 1], grid_sample align_corners=False, zero padding.

  * deform_sample_scores — sums of attention-weighted bilinear samples of a
    per-query score map S = K V^T (UVCoarse / UVCross), an autograd.Function.
    For CUDA tensors it launches the hand-written kernels (K5 forward,
    csrc/deform_scores.cu; K6 backward, csrc/deform_scores_bwd.cu, which sums
    each gradient row in a fixed order wherever the row fits in shared
    memory); for CPU tensors it runs their plain versions (the gather
    oracle, and deform_sample_scores_bwd_plain).
  * deform_sample_vectors — classic deformable attention over value vectors
    (UVSelf), an autograd.Function as well: for CUDA tensors K7 forward
    (csrc/deform_vectors.cu) and K8 backward (csrc/deform_vectors_bwd.cu,
    atomic adds into d_value, or a sorted, deterministic mode whose corners
    are ordered by a hand-written stable counting sort, `vectors_bwd_order`);
    for CPU tensors deform_sample_vectors_plain (float32 gathers) and
    deform_sample_vectors_bwd_plain.

Every function takes any number of leading batch dims (the directed view
pairs of the depth predictor). Both samplers run inside the spans
`deform.scores` / `deform.vectors`, their backwards inside
`deform.scores_bwd` / `deform.vectors_bwd` (utils/trace.py).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils.trace import span


def _corners(loc01: torch.Tensor, h: int, w: int):
    """loc01 (..., 2) -> flat corner indices (4, ...) int64 (clipped into the
    map), in-map masks (4, ...), and the fractions wx, wy (...).

    px = loc_x * W - 0.5 and floor(px) in float32, as the JAX `_prep` does.
    Corner order: (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)."""
    px = loc01[..., 0] * w - 0.5
    py = loc01[..., 1] * h - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = px - x0
    wy = py - y0
    # Far outside the map every corner is padding; the clamp keeps the
    # integer conversion defined without changing which corners are inside.
    x0i = torch.clamp(x0, -2.0, w + 1.0).to(torch.int64)
    y0i = torch.clamp(y0, -2.0, h + 1.0).to(torch.int64)
    idx, inside = [], []
    for iy, ix in ((y0i, x0i), (y0i, x0i + 1), (y0i + 1, x0i), (y0i + 1, x0i + 1)):
        inside.append((iy >= 0) & (iy < h) & (ix >= 0) & (ix < w))
        idx.append(torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1))
    return torch.stack(idx), torch.stack(inside), wx, wy


def _bilinear_weights(loc01: torch.Tensor, h: int, w: int):
    """loc01 (..., 2) -> flat corner indices (4, ...) int64 and weights (4, ...);
    out-of-range corners get weight 0 (and a clipped, harmless index)."""
    idx, inside, wx, wy = _corners(loc01, h, w)
    weights = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy])
    return idx, torch.where(inside, weights, torch.zeros_like(weights))


def deform_sample_scores_gather(
    scores: torch.Tensor,  # (..., Q, H*W)
    spatial_shape: tuple[int, int],
    loc01: torch.Tensor,  # (..., Q, D, P, 2)
    attn_weights: torch.Tensor,  # (..., Q, D, P)
) -> torch.Tensor:
    """Gather + weights: out[q, d] = sum_p aw * bilinear(scores[q], loc). -> (..., Q, D)."""
    h, w = spatial_shape
    hw = scores.shape[-1]
    flat = scores.reshape(-1, hw)
    idx, wgt = _bilinear_weights(loc01.reshape(flat.shape[0], *loc01.shape[-3:]), h, w)
    rows = torch.arange(flat.shape[0], device=scores.device)[None, :, None, None]
    sampled = flat.reshape(-1)[rows * hw + idx]  # (4, N, D, P)
    aw = attn_weights.reshape(flat.shape[0], *attn_weights.shape[-2:])
    out = torch.sum(sampled * wgt * aw[None], dim=(0, 3))
    return out.reshape(*scores.shape[:-1], loc01.shape[-3])


# The plain PyTorch version of K5 is the gather oracle itself.
deform_sample_scores_plain = deform_sample_scores_gather


def deform_sample_scores_bwd_plain(
    scores: torch.Tensor,  # (..., Q, H*W)
    spatial_shape: tuple[int, int],
    loc01: torch.Tensor,  # (..., Q, D, P, 2)
    attn_weights: torch.Tensor,  # (..., Q, D, P)
    gbar: torch.Tensor,  # (..., Q, D) cotangent of the output
):
    """Plain PyTorch version of K6: (d_scores, d_loc, d_attn_weights), written
    out term by term as the kernel computes them. floor() is a constant and a
    corner outside the map contributes 0 to every gradient."""
    h, w = spatial_shape
    hw = scores.shape[-1]
    flat = scores.reshape(-1, hw)
    n = flat.shape[0]
    d, p = loc01.shape[-3], loc01.shape[-2]
    idx, inside, wx, wy = _corners(loc01.reshape(n, d, p, 2), h, w)
    at = torch.arange(n, device=scores.device)[None, :, None, None] * hw + idx  # (4, N, D, P)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    v00, v01, v10, v11 = torch.where(inside, flat.reshape(-1)[at], zero)
    w00, w01, w10, w11 = (1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy
    gb = gbar.reshape(n, d, 1)
    s = gb * attn_weights.reshape(n, d, p)
    d_aw = gb * (v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11)
    d_loc = torch.stack(
        [
            s * w * ((1 - wy) * (v01 - v00) + wy * (v11 - v10)),
            s * h * ((1 - wx) * (v10 - v00) + wx * (v11 - v01)),
        ],
        dim=-1,
    )
    spread = torch.where(inside, s[None] * torch.stack([w00, w01, w10, w11]), zero)
    d_scores = torch.zeros(n * hw, dtype=scores.dtype, device=scores.device)
    d_scores.index_add_(0, at.reshape(-1), spread.reshape(-1))
    return d_scores.reshape(scores.shape), d_loc.reshape(loc01.shape), d_aw.reshape(attn_weights.shape)


def _check_scores_args(scores, spatial_shape, loc01, attn_weights):
    h, w = spatial_shape
    *lead, q, hw = scores.shape
    d, p = loc01.shape[-3], loc01.shape[-2]
    if hw != h * w:
        raise ValueError(f"scores: last dim {hw} != {h} * {w}")
    if tuple(loc01.shape) != (*lead, q, d, p, 2) or tuple(attn_weights.shape) != (*lead, q, d, p):
        raise ValueError(
            f"shapes disagree: scores {tuple(scores.shape)}, loc {tuple(loc01.shape)}, "
            f"weights {tuple(attn_weights.shape)}"
        )
    for name, t in (("scores", scores), ("loc01", loc01), ("attn_weights", attn_weights)):
        kernels.check_cuda_tensor(name, t, torch.float32)


def _scores_fwd_cuda(scores, spatial_shape, loc01, attn_weights):
    """Launch K5 on contiguous float32 CUDA tensors."""
    _check_scores_args(scores, spatial_shape, loc01, attn_weights)
    if loc01.data_ptr() % 8:  # K5 reads a location as one 8-byte vector
        loc01 = loc01.clone()
    h, w = spatial_shape
    d, p = loc01.shape[-3], loc01.shape[-2]
    out = torch.empty((*scores.shape[:-1], d), dtype=torch.float32, device=scores.device)
    n = out.numel() // d if d else 0
    kernels.call(
        "tp_deform_scores", f"deform_scores_p{p}",
        scores.data_ptr(), loc01.data_ptr(), attn_weights.data_ptr(), out.data_ptr(),
        n, h, w, d, p,
    )
    return out


# Dynamic shared memory a K6 block may take (csrc/deform_scores_bwd.cu).
SCORES_BWD_SMEM = 227 * 1024 - 1024
SCORES_BWD_PATHS = {"general": 0, "direct": 1, "staged": 2}
SCORES_BWD_MAX_SAMPLES = 4096  # D P of a query for the fixed-point rows


def scores_bwd_plan(h: int, w: int, d: int, p: int, scores_aligned: bool = True) -> str:
    """K6's path for one shape: "staged", "direct" or "general".

    A K6 block sums a query's gradient row as fixed-point integers in shared
    memory (two 32-bit words, 8 bytes a cell; up to 4096 samples a query).
    "staged" also keeps two score rows there (4 bytes a cell each), filled
    by bulk copies, where the samples touch most of the row (16 D P >= H W,
    as K5 decides) and the row can be copied in 16-byte units; "direct"
    reads the corners from device memory. Both give the same bits on every
    run. Other shapes take "general": device-memory float atomics, whose
    last bits vary."""
    hw = h * w
    cells = -(-hw // 4) * 4
    if d * p > SCORES_BWD_MAX_SAMPLES:
        return "general"
    staged = 16 * d * p >= hw and hw % 4 == 0 and scores_aligned
    if staged and 16 * cells <= SCORES_BWD_SMEM:
        return "staged"
    if 8 * cells <= SCORES_BWD_SMEM:
        return "direct"
    return "general"


def _scores_bwd_cuda(scores, spatial_shape, loc01, attn_weights, gbar, deterministic: bool = False):
    """Launch K6 on contiguous float32 CUDA tensors. Where the gradient row
    fits in shared memory (every shape of the paths) the result has the same
    bits on every run; otherwise `deterministic` raises rather than take the
    general path's atomics."""
    _check_scores_args(scores, spatial_shape, loc01, attn_weights)
    if loc01.data_ptr() % 8:  # K6 reads and writes a location as one 8-byte vector
        loc01 = loc01.clone()
    h, w = spatial_shape
    d, p = loc01.shape[-3], loc01.shape[-2]
    kernels.check_cuda_tensor("gbar", gbar, torch.float32)
    if tuple(gbar.shape) != (*scores.shape[:-1], d):
        raise ValueError(f"gbar: shape {tuple(gbar.shape)} is not the output's {(*scores.shape[:-1], d)}")
    path = scores_bwd_plan(h, w, d, p, scores.data_ptr() % 16 == 0)
    if path == "general" and deterministic:
        raise ValueError(
            f"deform_sample_scores: a {h}x{w} gradient row does not fit in shared memory, so K6 would add "
            "with atomics whose order varies; no deterministic backward for this shape"
        )
    d_scores, d_loc, d_aw = torch.empty_like(scores), torch.empty_like(loc01), torch.empty_like(attn_weights)
    n = gbar.numel() // d if d else 0
    kernels.call(
        "tp_deform_scores_bwd", f"deform_scores_bwd_p{p}",
        scores.data_ptr(), loc01.data_ptr(), attn_weights.data_ptr(), gbar.data_ptr(),
        d_scores.data_ptr(), d_loc.data_ptr(), d_aw.data_ptr(), n, h, w, d, p, SCORES_BWD_PATHS[path],
    )
    return d_scores, d_loc, d_aw


class DeformSampleScores(torch.autograd.Function):
    """deform_sample_scores with its hand-written backward: the kernels K5 and
    K6 for CUDA tensors, their plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, scores, loc01, attn_weights, spatial_shape, deterministic):
        scores, loc01, attn_weights = (t.contiguous() for t in (scores, loc01, attn_weights))
        ctx.save_for_backward(scores, loc01, attn_weights)
        ctx.spatial_shape, ctx.deterministic = spatial_shape, deterministic
        if scores.is_cuda:
            return _scores_fwd_cuda(scores, spatial_shape, loc01, attn_weights)
        return deform_sample_scores_plain(scores, spatial_shape, loc01, attn_weights)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gbar):
        scores, loc01, attn_weights = ctx.saved_tensors
        args = (scores, ctx.spatial_shape, loc01, attn_weights, gbar.contiguous())
        with span("deform.scores_bwd"):
            if scores.is_cuda:
                d_scores, d_loc, d_aw = _scores_bwd_cuda(*args, deterministic=ctx.deterministic)
            else:
                d_scores, d_loc, d_aw = deform_sample_scores_bwd_plain(*args)
        need = ctx.needs_input_grad
        return (d_scores if need[0] else None, d_loc if need[1] else None, d_aw if need[2] else None, None, None)


def deform_sample_scores(
    scores: torch.Tensor,
    spatial_shape: tuple[int, int],
    loc01: torch.Tensor,
    attn_weights: torch.Tensor,
    deterministic: bool = False,
) -> torch.Tensor:
    """K5 / K6: (..., Q, H*W) score maps sampled at (..., Q, D, P, 2) -> (..., Q, D).

    Differentiable in scores, locations and weights on both devices; on the
    card forward and backward are the hand-written kernels. K6 gives the same
    bits on every run wherever its gradient row fits in shared memory;
    `deterministic` makes the backward raise for a shape where it does not."""
    with span("deform.scores"):
        return DeformSampleScores.apply(scores, loc01, attn_weights, tuple(spatial_shape), deterministic)


def deform_sample_vectors_plain(
    value: torch.Tensor,  # (..., H*W, C)
    spatial_shape: tuple[int, int],
    loc01: torch.Tensor,  # (..., Q, P, 2)
    attn_weights: torch.Tensor,  # (..., Q, P)
) -> torch.Tensor:
    """Plain PyTorch version of K7: weighted bilinear sampling of value
    vectors -> (..., Q, C), float32 gathers."""
    h, w = spatial_shape
    hw, c = value.shape[-2:]
    flat = value.reshape(-1, hw, c)
    n = flat.shape[0]
    q, p = attn_weights.shape[-2:]
    idx, wgt = _bilinear_weights(loc01.reshape(n, q, p, 2), h, w)  # (4, N, Q, P)
    rows = torch.arange(n, device=value.device)[None, :, None, None]
    sampled = flat.reshape(-1, c)[rows * hw + idx]  # (4, N, Q, P, C)
    weight = wgt * attn_weights.reshape(n, q, p)[None]
    out = torch.einsum("knqp,knqpc->nqc", weight, sampled)
    return out.reshape(*value.shape[:-2], q, c)


def deform_sample_vectors_bwd_plain(
    value: torch.Tensor,  # (..., H*W, C)
    spatial_shape: tuple[int, int],
    loc01: torch.Tensor,  # (..., Q, P, 2)
    attn_weights: torch.Tensor,  # (..., Q, P)
    gbar: torch.Tensor,  # (..., Q, C) cotangent of the output
):
    """Plain PyTorch version of K8: (d_value, d_loc, d_attn_weights), written
    out term by term as the kernel computes them. floor() is a constant and a
    corner outside the map contributes 0 to every gradient."""
    h, w = spatial_shape
    hw, c = value.shape[-2:]
    flat = value.reshape(-1, hw, c)
    n = flat.shape[0]
    q, p = attn_weights.shape[-2:]
    idx, inside, wx, wy = _corners(loc01.reshape(n, q, p, 2), h, w)  # (4, N, Q, P), (N, Q, P)
    at = torch.arange(n, device=value.device)[None, :, None, None] * hw + idx
    gb = gbar.reshape(n, q, 1, c)
    zero = torch.zeros((), dtype=value.dtype, device=value.device)
    # s_corner = <gbar[q], V[idx_corner]>, 0 outside the map.
    s00, s01, s10, s11 = torch.where(inside, (flat.reshape(-1, c)[at] * gb[None]).sum(dim=-1), zero)
    w00, w01, w10, w11 = (1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy
    aw = attn_weights.reshape(n, q, p)
    d_aw = s00 * w00 + s01 * w01 + s10 * w10 + s11 * w11
    d_loc = torch.stack(
        [
            aw * w * ((1 - wy) * (s01 - s00) + wy * (s11 - s10)),
            aw * h * ((1 - wx) * (s10 - s00) + wx * (s11 - s01)),
        ],
        dim=-1,
    )
    spread = torch.where(inside, torch.stack([w00, w01, w10, w11]) * aw[None], zero)  # (4, N, Q, P)
    d_value = torch.zeros((n * hw, c), dtype=value.dtype, device=value.device)
    d_value.index_add_(0, at.reshape(-1), (spread[..., None] * gb[None]).reshape(-1, c))
    return d_value.reshape(value.shape), d_loc.reshape(loc01.shape), d_aw.reshape(attn_weights.shape)


def _check_vectors_args(value, spatial_shape, loc01, attn_weights):
    h, w = spatial_shape
    *lead, hw, _ = value.shape
    q, p = attn_weights.shape[-2:]
    if hw != h * w:
        raise ValueError(f"value: {hw} rows != {h} * {w}")
    if tuple(loc01.shape) != (*lead, q, p, 2) or tuple(attn_weights.shape) != (*lead, q, p):
        raise ValueError(
            f"shapes disagree: value {tuple(value.shape)}, loc {tuple(loc01.shape)}, "
            f"weights {tuple(attn_weights.shape)}"
        )
    for name, t in (("value", value), ("loc01", loc01), ("attn_weights", attn_weights)):
        kernels.check_cuda_tensor(name, t, torch.float32)


def _vectors_fwd_cuda(value, spatial_shape, loc01, attn_weights):
    """Launch K7 on contiguous float32 CUDA tensors."""
    _check_vectors_args(value, spatial_shape, loc01, attn_weights)
    h, w = spatial_shape
    c = value.shape[-1]
    q, p = attn_weights.shape[-2:]
    out = torch.empty((*value.shape[:-2], q, c), dtype=torch.float32, device=value.device)
    n = value.numel() // (h * w * c) if h * w * c else 0
    kernels.call(
        "tp_deform_vectors", "deform_vectors",
        value.data_ptr(), loc01.data_ptr(), attn_weights.data_ptr(), out.data_ptr(), n, q, h, w, c, p,
    )
    return out


# A K8 block keeps at least one query's 4 P corner entries in shared memory (4096 at most).
VECTORS_BWD_MAX_POINTS = 1024


# The sorted mode. Corner e = 4 (query point) + corner of the flattened
# (N, Q, P) points has the key n * HW + its map index, or N * HW outside
# the map. Its order is `perm` (E,) int32, the corners by key (ties in
# corner order: torch.sort(keys, stable=True)), with `offsets` (N * HW + 2,)
# int32, each key's segment start (CSR; the last key is "outside").

# Consecutive corners a block of the counting sort takes (kSortChunk in
# csrc/deform_vectors_bwd.cu): the count table has one column per chunk.
VECTORS_SORT_CHUNK = 2048


def vectors_bwd_keys_plain(loc01: torch.Tensor, attn_weights: torch.Tensor, h: int, w: int):
    """Plain version of what the sorted mode's first kernel writes besides
    d_loc and d_aw: each corner's key (E,) int32 and weight aw * w_corner (E,)."""
    q, p = attn_weights.shape[-2:]
    n = attn_weights.numel() // (q * p) if q * p else 0
    idx, inside, wx, wy = _corners(loc01.reshape(n, q, p, 2), h, w)  # (4, N, Q, P)
    weight = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy]) * attn_weights.reshape(n, q, p)
    row = torch.arange(n, device=idx.device)[None, :, None, None] * (h * w) + idx
    keys = torch.where(inside, row, n * h * w)
    return keys.permute(1, 2, 3, 0).reshape(-1).to(torch.int32), weight.permute(1, 2, 3, 0).reshape(-1)


def vectors_bwd_order_by_sort(keys: torch.Tensor, n_rows: int):
    """The order by torch.sort(keys, stable=True) and the runs' starts: the
    reference the counting sort is held to (tests only)."""
    keys_sorted, perm = torch.sort(keys, stable=True)
    bounds = torch.arange(n_rows + 2, dtype=keys.dtype, device=keys.device)
    return perm.to(torch.int32), torch.searchsorted(keys_sorted, bounds).to(torch.int32)


def vectors_bwd_order_plain(keys: torch.Tensor, n_rows: int, chunk: int = 256):
    """Plain version of the counting sort, with no sort: each corner goes to
    its key's start + the corners of earlier chunks with its key (a count per
    key and chunk, its prefix over the chunks) + the earlier corners of its
    own chunk with its key (compared pairwise)."""
    e = keys.shape[0]
    k = keys.to(torch.int64)
    offsets = torch.cat([k.new_zeros(1), torch.cumsum(torch.bincount(k, minlength=n_rows + 1), 0)])
    chunks = -(-e // chunk)
    chunk_of = torch.arange(e, device=k.device) // chunk
    table = torch.bincount(k * chunks + chunk_of, minlength=(n_rows + 1) * chunks).reshape(n_rows + 1, chunks)
    earlier_chunks = torch.cumsum(table, 1) - table
    padded = torch.cat([k, k.new_full((chunks * chunk - e,), -1)]).reshape(chunks, chunk)
    lower = torch.ones(chunk, chunk, dtype=torch.bool, device=k.device).tril(-1)
    in_chunk = ((padded[:, :, None] == padded[:, None, :]) & lower).sum(-1).reshape(-1)[:e]
    place = offsets[k] + earlier_chunks[k, chunk_of] + in_chunk
    perm = torch.empty(e, dtype=torch.int32, device=k.device)
    perm[place] = torch.arange(e, dtype=torch.int32, device=k.device)
    return perm, offsets.to(torch.int32)


def vectors_bwd_order(keys: torch.Tensor, n_batch: int, hw: int):
    """K8's sorted-mode order (perm, offsets) for keys (n_batch * per_batch,)
    int32, batch entry n's corners the n-th run: the counting sort of
    csrc/deform_vectors_bwd.cu `tp_deform_vectors_bwd_order` for CUDA keys,
    vectors_bwd_order_plain for CPU keys."""
    if not keys.is_cuda:
        return vectors_bwd_order_plain(keys, n_batch * hw)
    kernels.check_cuda_tensor("keys", keys, torch.int32, 1)
    e = keys.shape[0]
    if e == 0:
        return keys.new_empty(0), torch.zeros(n_batch * hw + 2, dtype=torch.int32, device=keys.device)
    if n_batch <= 0 or e % n_batch or n_batch > 65535 or e >= 2**31 or n_batch * (hw + 1) + 1 >= 2**31:
        raise ValueError(f"vectors_bwd_order: {e} keys of {n_batch} batch entries (at most 65535, fewer than 2**31 keys)")
    per_batch = e // n_batch
    chunks = -(-per_batch // VECTORS_SORT_CHUNK)
    rows = n_batch * (hw + 1)
    scratch_ints = -(-rows * chunks // 4) * 4 + 2 * (-(-rows // 4) * 4) + 1
    if scratch_ints >= 2**31:
        raise ValueError(f"vectors_bwd_order: {scratch_ints} ints of count table do not fit in int32")
    perm = torch.empty(e, dtype=torch.int32, device=keys.device)
    offsets = torch.empty(n_batch * hw + 2, dtype=torch.int32, device=keys.device)
    scratch = torch.empty(scratch_ints, dtype=torch.int32, device=keys.device)
    kernels.call(
        "tp_deform_vectors_bwd_order", "deform_vectors_bwd_order",
        keys.data_ptr(), scratch.data_ptr(), offsets.data_ptr(), perm.data_ptr(), n_batch, per_batch, hw,
    )
    return perm, offsets


def vectors_bwd_sorted_plain(gbar, corner_w, perm, offsets, corners_per_query: int) -> torch.Tensor:
    """Plain version of the row sums: d_value (N * HW, C), row r the sum over
    its segment's corners, in segment order from 0, of corner_w * gbar[query]."""
    c = gbar.shape[-1]
    g = gbar.reshape(-1, c)
    n_rows = offsets.shape[0] - 2
    starts = offsets[:n_rows].to(torch.int64)
    lengths = (offsets[1 : n_rows + 1] - offsets[:n_rows]).to(torch.int64)
    d_value = torch.zeros((n_rows, c), dtype=g.dtype, device=g.device)
    for depth in range(int(lengths.max()) if lengths.numel() else 0):
        rows = torch.nonzero(lengths > depth).squeeze(1)
        corner = perm[starts[rows] + depth].to(torch.int64)
        d_value[rows] = d_value[rows] + corner_w[corner][:, None] * g[corner // corners_per_query]
    return d_value


def vectors_bwd_sorted(gbar, corner_w, perm, offsets, corners_per_query: int) -> torch.Tensor:
    """The sorted mode's row sums (csrc/deform_vectors_bwd.cu
    `tp_deform_vectors_bwd_sorted`) for CUDA tensors, vectors_bwd_sorted_plain for CPU ones."""
    if not gbar.is_cuda:
        return vectors_bwd_sorted_plain(gbar, corner_w, perm, offsets, corners_per_query)
    kernels.check_cuda_tensor("gbar", gbar, torch.float32)
    kernels.check_cuda_tensor("corner_w", corner_w, torch.float32, 1)
    kernels.check_cuda_tensor("perm", perm, torch.int32, 1)
    kernels.check_cuda_tensor("offsets", offsets, torch.int32, 1)
    c = gbar.shape[-1]
    if perm.shape != corner_w.shape or corner_w.shape[0] != gbar.numel() // c * corners_per_query:
        raise ValueError("vectors_bwd_sorted: gbar, corner_w and perm disagree")
    d_value = torch.empty((offsets.shape[0] - 2, c), dtype=torch.float32, device=gbar.device)
    kernels.call(
        "tp_deform_vectors_bwd_sorted", "deform_vectors_bwd_sorted",
        gbar.data_ptr(), corner_w.data_ptr(), perm.data_ptr(), offsets.data_ptr(), d_value.data_ptr(),
        d_value.shape[0], c, corners_per_query,
    )
    return d_value


def deform_sample_vectors_bwd_sorted_plain(value, spatial_shape, loc01, attn_weights, gbar):
    """Plain version of K8's sorted mode: (d_value, d_loc, d_attn_weights),
    d_value from the corners' keys, their order with no sort and the
    in-order row sums; d_loc and d_attn_weights as deform_sample_vectors_bwd_plain."""
    h, w = spatial_shape
    p = attn_weights.shape[-1]
    n = value.numel() // (h * w * value.shape[-1]) if value.numel() else 0
    _, d_loc, d_aw = deform_sample_vectors_bwd_plain(value, spatial_shape, loc01, attn_weights, gbar)
    keys, corner_w = vectors_bwd_keys_plain(loc01, attn_weights, h, w)
    perm, offsets = vectors_bwd_order_plain(keys, n * h * w)
    d_value = vectors_bwd_sorted_plain(gbar, corner_w, perm, offsets, 4 * p)
    return d_value.reshape(value.shape), d_loc, d_aw


def _vectors_bwd_launch(value, spatial_shape, loc01, attn_weights, gbar, deterministic: bool):
    """Check K8's arguments and launch its first kernel: atomic mode ->
    (d_value, d_loc, d_aw); sorted mode -> (keys, corner_w, d_loc, d_aw)."""
    _check_vectors_args(value, spatial_shape, loc01, attn_weights)
    h, w = spatial_shape
    hw, c = value.shape[-2:]
    q, p = attn_weights.shape[-2:]
    kernels.check_cuda_tensor("gbar", gbar, torch.float32)
    if tuple(gbar.shape) != (*value.shape[:-2], q, c):
        raise ValueError(f"gbar: shape {tuple(gbar.shape)} is not the output's {(*value.shape[:-2], q, c)}")
    if p > VECTORS_BWD_MAX_POINTS:
        raise ValueError(f"deform_sample_vectors: K8 takes at most {VECTORS_BWD_MAX_POINTS} points, got {p}")
    if loc01.data_ptr() % 8:  # K8 reads and writes a location as one 8-byte vector
        loc01 = loc01.clone()
    n = value.numel() // (hw * c) if hw * c else 0
    d_loc, d_aw = torch.empty_like(loc01), torch.empty_like(attn_weights)
    args = (value.data_ptr(), loc01.data_ptr(), attn_weights.data_ptr(), gbar.data_ptr())
    if not deterministic:
        d_value = torch.zeros_like(value)
        kernels.call("tp_deform_vectors_bwd", "deform_vectors_bwd",
                     *args, d_value.data_ptr(), d_loc.data_ptr(), d_aw.data_ptr(), None, None, n, q, h, w, c, p)
        return d_value, d_loc, d_aw
    entries = n * q * p * 4
    if n * (hw + 1) + 1 >= 2**31 or entries >= 2**31:
        raise ValueError("deform_sample_vectors: batch * (H * W + 1) and the corners must fit in int32 in the deterministic mode")
    keys = torch.empty(entries, dtype=torch.int32, device=value.device)
    corner_w = torch.empty(entries, dtype=torch.float32, device=value.device)
    kernels.call("tp_deform_vectors_bwd", "deform_vectors_bwd_keys",
                 *args, None, d_loc.data_ptr(), d_aw.data_ptr(), keys.data_ptr(), corner_w.data_ptr(), n, q, h, w, c, p)
    return keys, corner_w, d_loc, d_aw


def _vectors_bwd_cuda(value, spatial_shape, loc01, attn_weights, gbar, deterministic: bool = False):
    """Launch K8 on contiguous float32 CUDA tensors. The default adds into a
    d_value zeroed here with float atomics (the last bits change from run to
    run); `deterministic` orders the corners by d_value row with the
    counting sort (vectors_bwd_order) and adds each row's segment in order
    (vectors_bwd_sorted)."""
    if not deterministic:
        return _vectors_bwd_launch(value, spatial_shape, loc01, attn_weights, gbar, False)
    keys, corner_w, d_loc, d_aw = _vectors_bwd_launch(value, spatial_shape, loc01, attn_weights, gbar, True)
    hw, c = value.shape[-2:]
    perm, offsets = vectors_bwd_order(keys, value.numel() // (hw * c) if hw * c else 0, hw)
    d_value = vectors_bwd_sorted(gbar, corner_w, perm, offsets, 4 * attn_weights.shape[-1])
    return d_value.reshape(value.shape), d_loc, d_aw


class DeformSampleVectors(torch.autograd.Function):
    """deform_sample_vectors with its hand-written backward: the kernels K7 and
    K8 for CUDA tensors, their plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, value, loc01, attn_weights, spatial_shape, deterministic):
        value, loc01, attn_weights = (t.contiguous() for t in (value, loc01, attn_weights))
        ctx.save_for_backward(value, loc01, attn_weights)
        ctx.spatial_shape, ctx.deterministic = spatial_shape, deterministic
        if value.is_cuda:
            return _vectors_fwd_cuda(value, spatial_shape, loc01, attn_weights)
        return deform_sample_vectors_plain(value, spatial_shape, loc01, attn_weights)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gbar):
        value, loc01, attn_weights = ctx.saved_tensors
        args = (value, ctx.spatial_shape, loc01, attn_weights, gbar.contiguous())
        with span("deform.vectors_bwd"):
            if value.is_cuda:
                d_value, d_loc, d_aw = _vectors_bwd_cuda(*args, deterministic=ctx.deterministic)
            else:
                d_value, d_loc, d_aw = deform_sample_vectors_bwd_plain(*args)
        need = ctx.needs_input_grad
        return (d_value if need[0] else None, d_loc if need[1] else None, d_aw if need[2] else None, None, None)


def deform_sample_vectors(
    value: torch.Tensor,  # (..., H*W, C)
    spatial_shape: tuple[int, int],
    loc01: torch.Tensor,  # (..., Q, P, 2)
    attn_weights: torch.Tensor,  # (..., Q, P)
    deterministic: bool = False,
) -> torch.Tensor:
    """K7 / K8: value maps (..., H*W, C) sampled at (..., Q, P, 2) -> (..., Q, C).

    Differentiable in values, locations and weights on both devices; on the
    card forward and backward are the hand-written kernels. `deterministic`
    picks K8's sorted mode (same bits on every run) over its atomic adds."""
    with span("deform.vectors"):
        return DeformSampleVectors.apply(value, loc01, attn_weights, tuple(spatial_shape), deterministic)
