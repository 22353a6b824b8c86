"""Gradients of the port's kernel-backed ops vs the JAX package, on the CPU.

On the CPU the port's autograd.Functions run the plain versions of the
backward kernels (K6 `deform_sample_scores_bwd_plain`, K4
`composite_tiles_bwd_plain`, K2 `bin_bwd_plain`), the same code paths and
plumbing the card takes with the kernels swapped in. They are held against

  * `jax.grad` through the JAX package on the same numpy inputs (the Pallas
    kernels in interpret mode where they support the shape, else the gather
    reference; the renderer in mode="reference"), and
  * `torch.autograd` of the forward's plain version.

Errors are measured relative to the largest entry of the gradient compared
(`scaled`), since gradients here span 1e-3 .. 1e2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rasterizer import _args, make_scene
from transplat_tpu.ops import deform as jax_deform
from transplat_tpu.ops.rasterizer import api as jax_api
from transplat_tpu.ops.rasterizer.api import RasterizeConfig as JaxCfg
from transplat_tpu_torch.ops import deform
from transplat_tpu_torch.ops.rasterizer import api, binning, composite, projection


def scaled(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# (a) deformable score sampling
# ---------------------------------------------------------------------------

# Each gradient entry is a sum of up to 4 P D float32 products taken in
# another order than JAX's separable matmuls: 2e-6 of the largest entry, the
# JAX suite's own bound between its Pallas and XLA backward
# (tests/test_ops_sampling.py::test_gradients_match_xla_vjp). Measured here:
# at most 1.8e-7, on exact corner boundaries and outside the map too.
DEFORM_TOL = 2e-6


def _deform_case(q, d, p, h, w, seed, lo=-0.05, hi=1.05, boundaries=False):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((q, h * w)).astype(np.float32)
    loc = rng.uniform(lo, hi, (q, d, p, 2)).astype(np.float32)
    if boundaries:  # exact corner boundaries: wx or wy is 0 and floor() sits on its step
        loc[:, : max(d // 2, 1)] = np.round(loc[:, : max(d // 2, 1)] * w) / w
    aw = rng.random((q, d, p)).astype(np.float32)
    cot = rng.standard_normal((q, d)).astype(np.float32)
    return scores, loc, aw, cot


def _port_deform_grads(fn, scores, loc, aw, cot, hw):
    leaves = [torch.from_numpy(a).clone().requires_grad_(True) for a in (scores, loc, aw)]
    out = fn(leaves[0], hw, leaves[1], leaves[2])
    return [g.numpy() for g in torch.autograd.grad(out, leaves, torch.from_numpy(cot))]


@pytest.mark.parametrize(
    "q,d,p,h,w,impl,kw",
    [
        (64, 32, 4, 8, 8, "pallas", {}),
        (64, 128, 1, 8, 8, "pallas", {}),
        (64, 32, 4, 8, 8, "pallas", {"boundaries": True}),
        (37, 5, 3, 7, 11, "gather", {}),
        (16, 6, 1, 8, 8, "gather", {"lo": -3.0, "hi": 4.0}),  # mostly outside the map
        (16, 6, 4, 5, 9, "gather", {"boundaries": True, "lo": -0.3, "hi": 1.3}),
    ],
)
def test_deform_scores_gradients_match_jax(q, d, p, h, w, impl, kw):
    from transplat_tpu.ops.deform_pallas import supported

    scores, loc, aw, cot = _deform_case(q, d, p, h, w, seed=q + d + p, **kw)
    if impl == "pallas":
        assert supported(q, d, p, h, w)
        fn = lambda s, l, a: jax_deform.deform_sample_scores(s, (h, w), l, a, impl="pallas")  # noqa: E731
    else:
        fn = lambda s, l, a: jax_deform.deform_sample_scores_gather(s, (h, w), l, a)  # noqa: E731
    ref = jax.grad(lambda s, l, a: jnp.sum(fn(s, l, a) * cot), argnums=(0, 1, 2))(
        jnp.asarray(scores), jnp.asarray(loc), jnp.asarray(aw)
    )
    got = _port_deform_grads(deform.deform_sample_scores, scores, loc, aw, cot, (h, w))
    for name, a, b in zip(("scores", "loc", "weights"), got, ref):
        assert scaled(a, b) <= DEFORM_TOL, (name, scaled(a, b))


@pytest.mark.parametrize("p,kw", [(1, {}), (4, {"boundaries": True}), (3, {"lo": -2.0, "hi": 3.0})])
def test_deform_scores_bwd_plain_matches_autograd(p, kw):
    """K6's plain version, with two leading batch dims, against autograd of K5's plain version."""
    q, d, h, w = 12, 6, 7, 9
    cases = [_deform_case(q, d, p, h, w, seed=s, **kw) for s in range(4)]
    scores, loc, aw, cot = (np.stack([c[i] for c in cases]).reshape(2, 2, *cases[0][i].shape) for i in range(4))
    auto = _port_deform_grads(deform.deform_sample_scores_plain, scores, loc, aw, cot, (h, w))
    t_scores, t_loc, t_aw, t_cot = (torch.from_numpy(a) for a in (scores, loc, aw, cot))
    plain = deform.deform_sample_scores_bwd_plain(t_scores, (h, w), t_loc, t_aw, t_cot)
    for name, a, b in zip(("scores", "loc", "weights"), plain, auto):
        assert a.shape == b.shape
        assert scaled(a.numpy(), b) <= DEFORM_TOL, (name, scaled(a.numpy(), b))


# ---------------------------------------------------------------------------
# (b) the renderer
# ---------------------------------------------------------------------------

BG = np.array([[0.2, 0.5, 0.9], [0.1, 0.0, 0.3]], np.float32)

# Both packages differentiate the same float32 formulas at the same point;
# what differs is the order of sums (over pixels, over a Gaussian's tiles).
# 1 / (1 - alpha) reaches 100 at the 0.99 cap and the conic's determinant
# cancels for elongated splats, which amplify that rounding: 5e-5 of the
# gradient's largest entry (measured: at most 6e-6 on these scenes).
RENDER_TOL = 5e-5


def _dense_scene(seed, g=400):
    """Large, opaque splats close together: capped alphas (0.99) and saturated tiles."""
    scene = make_scene(seed, g=g)
    rng = np.random.default_rng(seed)
    scene["covariances"] = scene["covariances"] * 9.0
    scene["means"][..., :2] *= 0.5
    opac = rng.uniform(0.6, 1.0, g).astype(np.float32)
    opac[: g // 4] = 1.0
    scene["opacities"] = np.broadcast_to(opac, scene["opacities"].shape).copy()
    return scene


@pytest.mark.parametrize("name,image_shape", [("mixed", (32, 48)), ("dense", (32, 32)), ("ragged", (24, 40))])
def test_render_gradients_match_jax_reference(name, image_shape):
    """d sum(colour * w) / d (means, covariances, SH, opacities, background):
    the port's tiled path (K3/K4/K2 plain versions) vs jax.grad through JAX's
    naive oracle."""
    scene = _dense_scene(11) if name == "dense" else make_scene(12, g=250)
    weight = np.random.default_rng(5).standard_normal((2, *image_shape, 3)).astype(np.float32)
    cam_j, g_j = _args(scene, jnp.asarray)
    cam_t, g_t = _args(scene, torch.from_numpy)

    def jax_loss(gs, bg):
        out = jax_api.render(*cam_j, image_shape, bg, *gs, cfg=JaxCfg(mode="reference"))
        return jnp.sum(out.color * weight)

    ref_g, ref_bg = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(g_j, jnp.asarray(BG))
    leaves = [t.clone().requires_grad_(True) for t in g_t]
    bg = torch.from_numpy(BG).clone().requires_grad_(True)
    color = api.render(*cam_t, image_shape, bg, *leaves).color
    if name == "dense":
        gfeat, colors = binning.sort_by_depth(projection.project_views(*cam_t[:2], cam_t[2], *g_t, image_shape))
        _, t_final, _ = composite.composite_tiles_plain(
            gfeat, colors, binning.bin_gaussians(gfeat, image_shape), torch.from_numpy(BG), image_shape
        )
        assert float((t_final < 1e-4).float().mean()) > 0.2  # saturated pixels
        assert float(gfeat[..., binning.OPACITY].max()) >= 0.99  # capped alphas
    got = torch.autograd.grad(torch.sum(color * torch.from_numpy(weight)), [*leaves, bg])
    for label, a, b in zip(("means", "covariances", "sh", "opacities", "background"), got, [*ref_g, ref_bg]):
        assert bool(torch.isfinite(a).all()), label
        assert scaled(a.numpy(), b) <= RENDER_TOL, (label, scaled(a.numpy(), b))


def test_render_depth_gradients_match_jax_reference():
    """C = 1: the expected-depth render's gradient in means, covariances and opacities."""
    scene = make_scene(13, g=250)
    image_shape = (32, 48)
    weight = np.random.default_rng(6).standard_normal((2, *image_shape)).astype(np.float32)
    cam_j, g_j = _args(scene, jnp.asarray)
    cam_t, g_t = _args(scene, torch.from_numpy)

    def jax_loss(m, c, o):
        return jnp.sum(jax_api.render_depth(*cam_j, image_shape, m, c, o, cfg=JaxCfg(mode="reference")) * weight)

    ref = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(g_j[0], g_j[1], g_j[3])
    leaves = [g_t[i].clone().requires_grad_(True) for i in (0, 1, 3)]
    depth = api.render_depth(*cam_t, image_shape, *leaves)
    got = torch.autograd.grad(torch.sum(depth * torch.from_numpy(weight)), leaves)
    for label, a, b in zip(("means", "covariances", "opacities"), got, ref):
        assert scaled(a.numpy(), b) <= RENDER_TOL, (label, scaled(a.numpy(), b))


@pytest.mark.parametrize("name,image_shape,channels", [("mixed", (40, 56), 3), ("dense", (32, 32), 3), ("mixed", (32, 48), 1)])
def test_composite_and_bin_bwd_plain_match_autograd(name, image_shape, channels):
    """K4's and K2's plain versions against autograd of K3's plain version,
    on the same lists: gradients of the geometry rows, colours and background."""
    scene = _dense_scene(21) if name == "dense" else make_scene(22, g=300)
    cam_t, g_t = _args(scene, torch.from_numpy)
    gfeat, colors = binning.sort_by_depth(projection.project_views(*cam_t[:2], cam_t[2], *g_t, image_shape))
    colors = colors[..., :channels].contiguous()
    lists = binning.bin_gaussians(gfeat, image_shape)
    bg = torch.from_numpy(BG)[:, :channels].contiguous()
    g_out = torch.from_numpy(np.random.default_rng(7).standard_normal((2, *image_shape, channels)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (gfeat, colors, bg)]
    image, t_final, _ = composite.composite_tiles_plain(*leaves[:2], lists, leaves[2], image_shape)
    auto = torch.autograd.grad(image, leaves, g_out)

    d_pair = composite.composite_tiles_bwd_plain(gfeat, colors, lists, bg, image.detach(), t_final.detach(), g_out)
    assert d_pair.shape == (lists.idx.shape[0], binning.pair_width(channels)) == (lists.idx.shape[0], 12)
    assert float(d_pair[:, 5].abs().max()) == 0.0  # the radius takes no gradient
    assert float(d_pair[:, 7].abs().max()) == 0.0 and float(d_pair[:, 8 + channels :].abs().max()) == 0.0  # pads
    d_gfeat, d_colors = binning.bin_bwd_plain(d_pair, lists, 2, gfeat.shape[1], channels)
    assert d_gfeat.shape == gfeat.shape and d_colors.shape == colors.shape
    leaves = [t.clone().requires_grad_(True) for t in (gfeat, colors, bg)]
    through = torch.autograd.grad(composite.composite_tiles(*leaves[:2], lists, leaves[2], image_shape), leaves, g_out)
    # The plain backward recomputes the forward's float32 values and sums them
    # in another order than autograd's chain of ops: 1e-5 of the largest entry
    # (measured: at most 5e-7).
    for label, a, b, c in zip(("gfeat", "colors"), (d_gfeat, d_colors), auto, through):
        assert scaled(a.numpy(), b.numpy()) <= 1e-5, (label, scaled(a.numpy(), b.numpy()))
        assert torch.equal(a, c), label  # the Function returns exactly these
    assert scaled(through[2].numpy(), auto[2].numpy()) <= 1e-5


@pytest.mark.parametrize("channels,width", [(1, 12), (3, 12), (4, 12), (5, 16), (8, 16)])
def test_padded_gradient_rows_round_trip(channels, width):
    """K4's and K2's gradient rows are 8 geometry columns plus the colours
    zero-padded to whole 16-byte vectors; K2's plain version on padded rows
    gives the (B, G, 8) and (B, G, C) gradients that index_add_ gives on the
    unpadded (8 + C) rows, and split_rows hands back exactly those columns."""
    assert binning.pair_width(channels) == width
    rng = np.random.default_rng(channels)
    views, g, tiles = 2, 30, 4
    lengths = rng.integers(0, 25, views * tiles)
    ends = np.cumsum(lengths)
    ranges = np.where((lengths > 0)[:, None], np.stack([ends - lengths, ends], 1), 0).astype(np.int32)
    n = int(ends[-1])
    lists = binning.TileLists(torch.from_numpy(rng.integers(0, g, n).astype(np.int32)), torch.from_numpy(ranges), 2, 2)
    rows = rng.standard_normal((n, 8 + channels)).astype(np.float32)
    rows[:, [5, 7]] = 0.0  # radius and pad take no gradient
    d_pair = np.zeros((n, width), np.float32)
    d_pair[:, : 8 + channels] = rows
    view = np.repeat(np.arange(views), [int(lengths[v * tiles : (v + 1) * tiles].sum()) for v in range(views)])
    want = np.zeros((views * g, 8 + channels), np.float32)
    np.add.at(want, view * g + lists.idx.numpy(), rows)
    want = want.reshape(views, g, 8 + channels)
    for fn in (binning.bin_bwd_plain, binning.bin_bwd):  # a CPU tensor takes the plain version
        d_gfeat, d_colors = fn(torch.from_numpy(d_pair), lists, views, g, channels)
        assert d_gfeat.shape == (views, g, 8) and d_colors.shape == (views, g, channels)
        np.testing.assert_allclose(d_gfeat.numpy(), want[..., :8], atol=1e-5)
        np.testing.assert_allclose(d_colors.numpy(), want[..., 8:], atol=1e-5)
    feat = torch.arange(views * g * width, dtype=torch.float32).reshape(views * g, width)
    geo, col = binning.split_rows(feat, views, g, channels)
    assert torch.equal(geo, feat.reshape(views, g, width)[..., :8])
    assert torch.equal(col, feat.reshape(views, g, width)[..., 8 : 8 + channels])


def test_project_gaussians_gradients_match_jax():
    """The projection's own gradient (ceil, clamps, the determinant) on inputs
    JAX handles safely: Gaussians in front of the camera, moderate axis ratios."""
    from transplat_tpu.geometry.projection import get_fov as jax_get_fov
    from transplat_tpu.ops.rasterizer.projection import project_gaussians as jax_project

    scene = make_scene(14, views=1, g=200)
    rng = np.random.default_rng(8)
    cots = {
        "mean2d": rng.standard_normal((200, 2)), "conic": rng.standard_normal((200, 3)),
        "rgb": rng.standard_normal((200, 3)), "depth": rng.standard_normal(200),
    }
    cots = {k: v.astype(np.float32) for k, v in cots.items()}
    fov = jax_get_fov(jnp.asarray(scene["intrinsics"]))[0]

    def jax_loss(m, c, s):
        p = jax_project(m, c, s, jnp.asarray(scene["opacities"][0]), jnp.asarray(scene["extrinsics"][0]),
                        jnp.tan(0.5 * fov[0]), jnp.tan(0.5 * fov[1]), (48, 64))
        return sum(jnp.sum(jnp.where(p.valid.reshape((-1,) + (1,) * (v.ndim - 1)), getattr(p, k), 0.0) * v) for k, v in cots.items())

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(scene[k][0]) for k in ("means", "covariances", "sh")))
    leaves = [torch.from_numpy(scene[k]).clone().requires_grad_(True) for k in ("means", "covariances", "sh")]
    cam_t, g_t = _args(scene, torch.from_numpy)
    p = projection.project_views(cam_t[0], cam_t[1], cam_t[2], leaves[0], leaves[1], leaves[2], g_t[3], (48, 64))
    loss = sum(
        torch.sum(torch.where(p.valid[0].reshape((-1,) + (1,) * (v.ndim - 1)), getattr(p, k)[0], 0.0) * torch.from_numpy(v))
        for k, v in cots.items()
    )
    got = torch.autograd.grad(loss, leaves)
    # conic = adj / det: the determinant's cancellation amplifies float32
    # rounding in its gradient (1 / det^2): 2e-5 of the largest entry
    # (measured 3.2e-6, on the covariances).
    for label, a, b in zip(("means", "covariances", "sh"), got, ref):
        assert bool(torch.isfinite(a).all()), label
        assert scaled(a[0].numpy(), b) <= 2e-5, (label, scaled(a[0].numpy(), b))


def test_culled_gaussians_get_zero_not_nan_gradients():
    """Gaussians behind the camera, or with a degenerate covariance, are
    masked with where(): their gradients are exactly 0, never NaN."""
    scene = make_scene(15, views=2, g=64)
    scene["means"][:, :8, 2] = -1.0  # behind the camera
    scene["covariances"][:, 8:12] = 0.0  # degenerate
    cam_t, g_t = _args(scene, torch.from_numpy)
    leaves = [t.clone().requires_grad_(True) for t in g_t]
    color = api.render(*cam_t, (32, 32), torch.from_numpy(BG), *leaves).color
    grads = torch.autograd.grad(color.sum(), leaves)
    for g in grads:
        assert bool(torch.isfinite(g).all())
    assert float(grads[0][:, :8].abs().max()) == 0.0 and float(grads[3][:, :8].abs().max()) == 0.0
