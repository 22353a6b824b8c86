"""Training steps that repeat their bits, on the CPU.

  * trainer.deterministic_kernels reaches the three autograd Functions whose
    backward kernels could vary (K6 DeformSampleScores, K8
    DeformSampleVectors, K4/K2 CompositeTiles) and the cuDNN flags, and the
    plain versions still compute the step;
  * CPU models of the two redesigned backward kernels, held against the
    plain versions: K6's fixed-point gradient row (csrc/deform_scores_bwd.cu)
    and K8's tile/halo partition of the corners (csrc/deform_vectors_bwd.cu),
    corners outside the window and far outside the map included;
  * K6's choice of path by shape (ops/deform.py scores_bwd_plan).

Tiny widths throughout.
"""

import numpy as np
import pytest
import torch

from test_torch_fit_eval import golden, tiny_cfg
from transplat_tpu_torch.ops import deform
from transplat_tpu_torch.ops.deform import DeformSampleScores, DeformSampleVectors, scores_bwd_plan
from transplat_tpu_torch.ops.rasterizer.composite import CompositeTiles
from transplat_tpu_torch.training import Trainer

FUNCTIONS = (DeformSampleScores, DeformSampleVectors, CompositeTiles)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """As in test_torch_fit_eval.py: tiny training steps with two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("switch", [False, True])
def test_switch_reaches_every_backward_and_cudnn(tmp_path, monkeypatch, switch):
    """One Trainer step on the CPU with trainer.deterministic_kernels set or
    not: every backward of the three Functions sees the switch in its
    context, and cuDNN's flags and PyTorch's deterministic mode are on
    during the step exactly when the switch is, and put back after it."""
    seen = []
    for fn in FUNCTIONS:
        def spy(ctx, *grads, _orig=fn.backward, _name=fn.__name__):
            seen.append((_name, ctx.deterministic, torch.backends.cudnn.deterministic,
                         torch.backends.cudnn.benchmark, torch.are_deterministic_algorithms_enabled()))
            return _orig(ctx, *grads)

        monkeypatch.setattr(fn, "backward", staticmethod(spy))
    before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
              torch.are_deterministic_algorithms_enabled())
    cfg = tiny_cfg(tmp_path, num_sanity_val_steps=0, max_steps=1, deterministic_kernels=switch)
    state = Trainer(cfg, log_fn=lambda m: None, device="cpu").fit(iter([golden()]), max_steps=1)
    assert state.step == 1
    names = {name for name, *_ in seen}
    assert names == {fn.__name__ for fn in FUNCTIONS}
    # The sampler runs once at P = 1 and twice per fine layer at P = 4 and as K7.
    assert len(seen) >= 5
    for name, ctx_flag, cudnn_det, cudnn_bench, torch_det in seen:
        assert ctx_flag is switch, name
        assert cudnn_det is switch and (cudnn_bench is False if switch else True), name
        assert torch_det is switch, name
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled()) == before


def test_switch_leaves_the_cpu_step_unchanged(tmp_path):
    """The plain versions compute the CPU step either way: two steps with and
    without the switch reach the same parameters bit for bit."""
    states = []
    for switch in (False, True):
        cfg = tiny_cfg(tmp_path / str(switch), num_sanity_val_steps=0, max_steps=2, deterministic_kernels=switch)
        states.append(Trainer(cfg, log_fn=lambda m: None, device="cpu").fit(iter([golden(), golden()]), max_steps=2))
    off, on = (s.encoder.state_dict() for s in states)
    for k in off:
        assert torch.equal(off[k], on[k]), k


# ---------------------------------------------------------------------------
# K6: the gradient row in fixed point
# ---------------------------------------------------------------------------


def k6_fixed_point_rows(scores, loc, aw, gbar, h, w, order=None):
    """CPU model of K6's d_scores: each query's row as 64-bit integers in
    units of 2^-e, e = 50 - k - L with every |gbar * aw| of the query below
    2^k and at most 2^L samples; each corner adds round(s * w_corner * 2^e)
    (float32 products, as the kernel forms them), in the sample order
    `order` (a permutation of the query's samples; integer adds do not
    depend on it); the row is read back as float32 of the integer sum times
    2^-e. A query whose d out or weights are not finite gets a NaN row."""
    q, d, p = aw.shape
    dp = d * p
    idx, inside, wx, wy = deform._corners(torch.from_numpy(loc), h, w)
    wx, wy = wx.numpy(), wy.numpy()
    weights = np.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy]).astype(np.float32)
    s = (gbar[:, :, None] * aw).astype(np.float32)  # (Q, D, P)
    out = np.zeros((q, h * w), np.float32)
    for qi in range(q):
        m = np.abs(s[qi]).max()
        if not np.isfinite(m):
            out[qi] = np.nan
            continue
        e = 0 if m == 0 else 50 - int(np.frexp(np.float32(m))[1]) - int(np.ceil(np.log2(dp)) if dp > 1 else 0)
        row = np.zeros(h * w, np.int64)
        samples = np.arange(dp) if order is None else order
        for j in samples:
            di, pi = divmod(int(j), p)
            for c in range(4):
                if inside[c, qi, di, pi]:
                    val = np.float32(s[qi, di, pi] * weights[c, qi, di, pi])
                    row[idx[c, qi, di, pi]] += np.int64(np.rint(np.ldexp(np.float64(val), e)))
        out[qi] = np.ldexp(row.astype(np.float32), -e)
    return out


def _k6_case(q, d, p, h, w, seed):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((q, h * w)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (q, d, p, 2)).astype(np.float32)
    loc[:, : d // 4] = np.round(loc[:, : d // 4] * w) / w  # exact corner boundaries
    loc[:, d // 4, :, :] = (0.5 + 0.01 * rng.standard_normal((p, 2))).astype(np.float32)  # one cell, many adds
    aw = rng.random((q, d, p)).astype(np.float32)
    gbar = (rng.standard_normal((q, d)) * np.logspace(-3, 2, q)[:, None]).astype(np.float32)  # rows of every scale
    return scores, loc, aw, gbar


@pytest.mark.parametrize("q,d,p,h,w", [(6, 16, 4, 8, 8), (5, 24, 1, 7, 9)])
def test_k6_fixed_point_row_matches_plain_in_any_order(q, d, p, h, w):
    """The fixed-point row equals the plain version's float sums within
    1e-6 of each row's largest entry (2^-40 of the largest contribution per
    add, below float32 rounding), and a shuffled sample order gives the
    same bits: the kernel's result does not depend on the order in which
    its threads add."""
    scores, loc, aw, gbar = _k6_case(q, d, p, h, w, q + d)
    got = k6_fixed_point_rows(scores, loc, aw, gbar, h, w)
    plain = deform.deform_sample_scores_bwd_plain(torch.from_numpy(scores), (h, w), torch.from_numpy(loc),
                                                  torch.from_numpy(aw), torch.from_numpy(gbar))[0]
    plain = plain.numpy()
    for qi in range(q):
        scale = np.abs(plain[qi]).max()
        np.testing.assert_allclose(got[qi], plain[qi], atol=1e-6 * scale, rtol=0, err_msg=f"query {qi}")
    order = np.random.default_rng(1).permutation(d * p)
    np.testing.assert_array_equal(k6_fixed_point_rows(scores, loc, aw, gbar, h, w, order), got)


def test_k6_fixed_point_row_of_a_non_finite_query_is_nan():
    scores, loc, aw, gbar = _k6_case(3, 8, 2, 6, 6, 0)
    gbar[1, 2] = np.inf
    got = k6_fixed_point_rows(scores, loc, aw, gbar, 6, 6)
    assert np.isnan(got[1]).all() and np.isfinite(got[[0, 2]]).all()


@pytest.mark.parametrize(
    "h,w,d,p,aligned,path",
    [
        (64, 64, 128, 4, True, "staged"),    # the path's cross-attention: the samples cover the row
        (64, 64, 128, 1, True, "direct"),    # the path's epipolar correlation: under 1/8 of the row
        (64, 64, 128, 4, False, "direct"),   # a score row the bulk copy cannot take
        (7, 11, 5, 3, True, "direct"),       # 77 cells: no 16-byte rows
        (90, 90, 128, 4, True, "staged"),    # 130 KB of staged rows and fixed-point row
        (128, 128, 256, 4, True, "direct"),  # 256 KB staged: over budget; the 128 KB row alone fits
        (256, 256, 4, 2, True, "general"),   # 512 KB of fixed-point row: device-memory atomics
    ],
)
def test_k6_path_by_shape(h, w, d, p, aligned, path):
    assert scores_bwd_plan(h, w, d, p, aligned) == path


# ---------------------------------------------------------------------------
# K8: tiles, windows and corners outside them
# ---------------------------------------------------------------------------

TILE, HALO = 8, 4


def k8_partition(loc, h, w):
    """CPU model of how K8's atomic mode splits the corners of a Q = H W map
    (N, Q, P, 2): each query belongs to the 8x8 tile of its pixel, whose
    window is the tile plus 4 cells on each side. Returns, per corner
    (4, N, Q, P): its map index (-1 outside the map) and whether it falls in
    its query's window."""
    n, q, p, _ = loc.shape
    idx, inside, _, _ = deform._corners(torch.from_numpy(loc), h, w)
    idx, inside = idx.numpy(), inside.numpy()
    qy, qx = np.divmod(np.arange(q), w)
    x0 = (qx // TILE * TILE - HALO)[None, None, :, None]
    y0 = (qy // TILE * TILE - HALO)[None, None, :, None]
    cy, cx = np.divmod(idx, w)
    in_window = inside & (cx >= x0) & (cx < x0 + 2 * HALO + TILE) & (cy >= y0) & (cy < y0 + 2 * HALO + TILE)
    return np.where(inside, idx, -1), in_window


def k8_d_value(value, loc, aw, gbar, h, w):
    """d_value as K8's atomic mode forms it: per tile, the window cells' sums
    (one add of each to d_value), and each corner outside the window added on
    its own. Also returns the adds each row of d_value takes from windows and
    from corners outside them."""
    n, q, p, _ = loc.shape
    c = value.shape[-1]
    idx, in_window = k8_partition(loc, h, w)
    _, _, wx, wy = deform._corners(torch.from_numpy(loc), h, w)
    wx, wy = wx.numpy(), wy.numpy()
    weights = np.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy]) * aw[None]
    d_value = np.zeros((n, h * w, c), np.float64)
    window_adds = np.zeros((n, h * w), np.int64)
    outside_adds = np.zeros((n, h * w), np.int64)
    tiles = (np.arange(q) // w) // TILE * ((w + TILE - 1) // TILE) + (np.arange(q) % w) // TILE
    for ni in range(n):
        for t in np.unique(tiles):
            window = {}
            for qi in np.flatnonzero(tiles == t):
                for cr in range(4):
                    for pi in range(p):
                        cell = idx[cr, ni, qi, pi]
                        if cell < 0:
                            continue
                        contrib = weights[cr, ni, qi, pi] * gbar[ni, qi]
                        if in_window[cr, ni, qi, pi]:
                            window[cell] = window.get(cell, 0.0) + contrib
                        else:
                            d_value[ni, cell] += contrib
                            outside_adds[ni, cell] += 1
            for cell, total in window.items():
                d_value[ni, cell] += total
                window_adds[ni, cell] += 1
    return d_value, window_adds, outside_adds


def _k8_case(n, h, w, c, p, seed):
    """Self-attention-like locations: the pixel centres plus N(0, 1.5 px), an
    eighth uniform over the map and beyond its edge, four far outside."""
    rng = np.random.default_rng(seed)
    q = h * w
    ys, xs = np.divmod(np.arange(q), w)
    centres = np.stack([(xs + 0.5) / w, (ys + 0.5) / h], -1)[None, :, None]
    loc = centres + rng.standard_normal((n, q, p, 2)) * (1.5 / w)
    loc[:, : q // 8] = rng.uniform(-0.1, 1.1, (n, q // 8, p, 2))
    loc[:, q // 8 : q // 8 + 4] *= 1e6
    value = rng.standard_normal((n, q, c)).astype(np.float32)
    aw = rng.random((n, q, p)).astype(np.float32)
    gbar = rng.standard_normal((n, q, c)).astype(np.float32)
    return value, loc.astype(np.float32), aw, gbar


def test_k8_tile_partition_matches_plain_and_cuts_the_adds():
    """Every in-map corner lands once, in its window or outside it; window
    sums plus outside corners equal the plain version's d_value; points far
    outside the map add nothing; with self-attention-like locations a row of
    d_value takes a few adds (one per covering window plus the odd outside
    corner) where the one-warp-per-query design took one per corner."""
    n, h, w, c, p = 2, 20, 24, 8, 4
    value, loc, aw, gbar = _k8_case(n, h, w, c, p, 3)
    idx, in_window = k8_partition(loc, h, w)
    assert (in_window <= (idx >= 0)).all()
    far = slice(h * w // 8, h * w // 8 + 4)
    assert (idx[:, :, far] == -1).all()
    share = in_window.sum() / (idx >= 0).sum()
    assert share > 0.8, share
    got, window_adds, outside_adds = k8_d_value(value, loc, aw, gbar, h, w)
    plain = deform.deform_sample_vectors_bwd_plain(torch.from_numpy(value), (h, w), torch.from_numpy(loc),
                                                   torch.from_numpy(aw), torch.from_numpy(gbar))[0]
    np.testing.assert_allclose(got, plain.numpy().astype(np.float64), atol=1e-5, rtol=1e-5)
    corners_per_row = np.zeros((n, h * w), np.int64)
    for ni in range(n):
        np.add.at(corners_per_row[ni], idx[:, ni][idx[:, ni] >= 0], 1)
    assert (window_adds + outside_adds <= corners_per_row).all()
    assert window_adds.max() <= 4  # a cell lies in the windows of at most 2 x 2 tiles
    touched = corners_per_row > 0
    adds = (window_adds + outside_adds)[touched].mean()
    assert adds < 0.5 * corners_per_row[touched].mean(), (adds, corners_per_row[touched].mean())
