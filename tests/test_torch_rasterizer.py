"""Port rasterizer (transplat_tpu_torch.ops.rasterizer) vs the JAX package.

The same numpy scenes go through both. On the CPU the port's `auto` mode
runs the plain versions of its kernels (K1 binning, K3 compositing); the
CUDA kernels themselves are held against those plain versions on the card
(chip_smoke.py and the `cuda` tests below).

Scenes include elongated covariances and opacities on both sides of 1/255,
so the exact significance cull of the binning is exercised where it removes
pairs. End-to-end renders use axis ratios up to 24; the rasterizer on its
own is fed the JAX package's projected Gaussians with ratios up to 60.
(There, det = ac - b^2 of the 2D covariance cancels: an ulp of difference
in the camera-space means, from a 3-term sum taken in another order, moves
the conic by ~1e-4 relative and the image by ~1e-3, so end to end the two
packages can only agree to 1e-5 on less extreme splats.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transplat_tpu.ops.rasterizer import api as jax_api
from transplat_tpu.ops.rasterizer.api import RasterizeConfig as JaxCfg
from transplat_tpu.ops.rasterizer import reference as jax_reference
from transplat_tpu.ops.rasterizer import tiles as jax_tiles
from transplat_tpu.ops.rasterizer.projection import project_gaussians as jax_project
from transplat_tpu.geometry.projection import get_fov as jax_get_fov
from transplat_tpu_torch.ops.rasterizer import api
from transplat_tpu_torch.ops.rasterizer.api import RasterizeConfig
from transplat_tpu_torch.ops.rasterizer.binning import bin_gaussians, sort_by_depth
from transplat_tpu_torch.ops.rasterizer.projection import ProjectedGaussians

# Colours are float32 sums of a few hundred alpha-weighted terms computed in
# a different order (cumprod per chunk vs per list): agreement to 1e-5.
COLOR_ATOL = 1e-5


def _rotation(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    return np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
        ],
        axis=1,
    ).reshape(n, 3, 3)


def make_scene(seed=0, views=2, g=300, sh_degree=1, stretch=(4.0, 8.0)):
    """Gaussians in front of B cameras; a third are needle-like (one axis
    scaled by `stretch`, another by 1/3), and a quarter have opacities
    straddling 1/255."""
    rng = np.random.default_rng(seed)
    means = np.stack(
        [rng.uniform(-1.5, 1.5, g), rng.uniform(-1.5, 1.5, g), rng.uniform(2.0, 6.0, g)], axis=1
    )
    scales = rng.uniform(0.01, 0.08, (g, 3))
    needle = rng.random(g) < 0.35
    scales[needle, 0] *= rng.uniform(*stretch, needle.sum())
    scales[needle, 1] /= 3.0
    rot = _rotation(rng, g)
    cov = rot @ (scales[:, :, None] ** 2 * np.transpose(rot, (0, 2, 1)))
    opac = rng.uniform(0.05, 0.95, g)
    faint = rng.random(g) < 0.25
    opac[faint] = rng.uniform(0.5 / 255, 2.5 / 255, faint.sum())
    sh = rng.standard_normal((g, 3, (sh_degree + 1) ** 2)) * 0.4
    extr = np.tile(np.eye(4), (views, 1, 1))
    extr[:, 0, 3] = np.linspace(-0.2, 0.2, views)
    extr[:, 1, 3] = rng.uniform(-0.1, 0.1, views)
    intr = np.tile(np.array([[1.2, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1.0]]), (views, 1, 1))
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    tile = lambda a: f32(np.broadcast_to(a, (views,) + a.shape))  # noqa: E731
    return dict(
        extrinsics=f32(extr), intrinsics=f32(intr), near=np.full(views, 1.0, np.float32),
        far=np.full(views, 100.0, np.float32), means=tile(means), covariances=tile(cov),
        sh=tile(sh), opacities=tile(opac),
    )


def _args(scene, to):
    keys = ("extrinsics", "intrinsics", "near", "far")
    return [to(scene[k]) for k in keys], [to(scene[k]) for k in ("means", "covariances", "sh", "opacities")]


def render_both(scene, image_shape, background, jax_cfg, cfg=RasterizeConfig()):
    cam_j, g_j = _args(scene, jnp.asarray)
    cam_t, g_t = _args(scene, torch.from_numpy)
    out_j = jax.jit(lambda c, bg, g: jax_api.render(*c, image_shape, bg, *g, cfg=jax_cfg))(
        cam_j, jnp.asarray(background), g_j
    )
    out_t = api.render(*cam_t, image_shape, torch.from_numpy(background), *g_t, cfg=cfg)
    return out_j, out_t


BG = np.array([[0.2, 0.5, 0.9], [0.0, 0.0, 0.0]], np.float32)
# JAX's tiled mode multiplies T_final by every factor, also past T < 1e-4,
# where the oracle (and the port) stop: against it, backgrounds are black.
BLACK = np.zeros((2, 3), np.float32)
TILED = JaxCfg(mode="tiled", binning="fast", capacity=1024, chunk=128)


def test_project_gaussians_matches_jax():
    scene = make_scene(1)
    proj_t = api.project_views(
        *(torch.from_numpy(scene[k]) for k in ("extrinsics", "intrinsics", "near", "means", "covariances", "sh", "opacities")),
        (48, 64),
    )
    for view in range(2):
        e = scene["extrinsics"][view].copy()
        e[:3, 3] /= scene["near"][view]
        fov = jax_get_fov(jnp.asarray(scene["intrinsics"][view])[None])[0]
        pj = jax_project(
            jnp.asarray(scene["means"][view]), jnp.asarray(scene["covariances"][view]),
            jnp.asarray(scene["sh"][view]), jnp.asarray(scene["opacities"][view]), jnp.asarray(e),
            jnp.tan(0.5 * fov[0]), jnp.tan(0.5 * fov[1]), (48, 64),
        )
        pt = proj_t.view(view)
        np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(pj.valid))
        np.testing.assert_array_equal(pt.radius.numpy(), np.asarray(pj.radius))
        for name in ("mean2d", "depth", "rgb"):
            np.testing.assert_allclose(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)), rtol=1e-5, atol=1e-5)
        # conic = adj / det, and det = ac - b^2 cancels for needle-like
        # splats: ulp-level differences in the camera-space means (a 3-term
        # matmul summed in another order) grow to ~2e-5 relative there.
        np.testing.assert_allclose(pt.conic.numpy(), np.asarray(pj.conic), rtol=1e-4, atol=1e-6)


def jax_projections(scene, image_shape):
    """The JAX package's per-view projection of a scene (near = 1)."""
    out = []
    for view in range(scene["means"].shape[0]):
        fov = jax_get_fov(jnp.asarray(scene["intrinsics"][view])[None])[0]
        out.append(
            jax_project(
                *(jnp.asarray(scene[k][view]) for k in ("means", "covariances", "sh", "opacities", "extrinsics")),
                jnp.tan(0.5 * fov[0]), jnp.tan(0.5 * fov[1]), image_shape,
            )
        )
    return out


def _stack_proj(projs) -> ProjectedGaussians:
    return ProjectedGaussians(
        *(torch.from_numpy(np.stack([np.asarray(getattr(p, f)) for p in projs])) for f in ProjectedGaussians._fields)
    )


@pytest.mark.parametrize("image_shape", [(48, 64), (40, 56)])
def test_rasterize_needles_matches_jax_tiled(image_shape):
    """K1 + K3 (plain versions) on the JAX package's own projected Gaussians,
    axis ratios up to 60, against JAX's tiled binning + compositing."""
    projs = jax_projections(make_scene(9, stretch=(8.0, 20.0)), image_shape)
    proj = _stack_proj(projs)
    img = api.rasterize(proj, image_shape, torch.from_numpy(BG))
    img_black = api.rasterize(proj, image_shape, torch.from_numpy(BLACK))
    for view, pj in enumerate(projs):
        lists = jax_tiles.bin_gaussians_fast(pj, image_shape, capacity=1024)
        assert int(lists.overflow) == 0
        ref = jax_tiles.composite_tiles(pj, lists, image_shape, jnp.asarray(BLACK[view]), chunk=128)
        np.testing.assert_allclose(img_black[view].numpy(), np.asarray(ref), atol=COLOR_ATOL)
        oracle = jax_reference.render_reference_view(pj, image_shape, jnp.asarray(BG[view]))
        np.testing.assert_allclose(img[view].numpy(), np.asarray(oracle), atol=COLOR_ATOL)


@pytest.mark.parametrize("image_shape", [(48, 64), (40, 56)])
def test_render_matches_jax_tiled(image_shape):
    out_j, out_t = render_both(make_scene(2), image_shape, BLACK, TILED)
    assert int(np.asarray(out_j.overflow).sum()) == 0 and int(out_t.overflow.sum()) == 0
    np.testing.assert_allclose(out_t.color.numpy(), np.asarray(out_j.color), atol=COLOR_ATOL)
    np.testing.assert_array_equal(out_t.radii.numpy(), np.asarray(out_j.radii))


def test_render_matches_jax_reference():
    scene = make_scene(3, g=200)
    out_j, out_t = render_both(scene, (32, 48), BG, JaxCfg(mode="reference"), RasterizeConfig(mode="reference"))
    np.testing.assert_allclose(out_t.color.numpy(), np.asarray(out_j.color), atol=COLOR_ATOL)
    # The tiled port (auto mode, plain versions here) against the JAX oracle.
    _, out_auto = render_both(scene, (32, 48), BG, JaxCfg(mode="reference"))
    np.testing.assert_allclose(out_auto.color.numpy(), np.asarray(out_j.color), atol=COLOR_ATOL)


def test_cull_drops_pairs():
    """The significance cull bins fewer pairs than the full radius rectangle
    (which JAX's tiled mode bins, and whose image the port matches above)."""
    scene = make_scene(4)
    cam_t, g_t = _args(scene, torch.from_numpy)
    proj = api.project_views(*cam_t[:2], cam_t[2], *g_t, (48, 64))
    gfeat, _ = sort_by_depth(proj)
    lists = bin_gaussians(gfeat, (48, 64))
    mx, my, r = gfeat[..., 0], gfeat[..., 1], gfeat[..., 5]
    live = r > 0
    x0 = torch.clamp(torch.floor((mx - r) / 16), 0, 4)
    x1 = torch.clamp(torch.floor((mx + r) / 16), -1, 3)
    y0 = torch.clamp(torch.floor((my - r) / 16), 0, 3)
    y1 = torch.clamp(torch.floor((my + r) / 16), -1, 2)
    full = torch.where(live, torch.clamp(x1 - x0 + 1, min=0) * torch.clamp(y1 - y0 + 1, min=0), 0)
    assert 0 < lists.idx.shape[0] < int(full.sum())
    # Every list is in depth order (ascending sorted rank) within its tile.
    for start, end in lists.ranges.tolist():
        assert torch.all(lists.idx[start + 1 : end] > lists.idx[start : end - 1])


@pytest.mark.parametrize("mode", ["depth", "disparity", "relative_disparity", "log"])
def test_render_depth_matches_jax(mode):
    scene = make_scene(5)
    cam_j, g_j = _args(scene, jnp.asarray)
    cam_t, g_t = _args(scene, torch.from_numpy)
    dj = jax_api.render_depth(*cam_j, (32, 48), g_j[0], g_j[1], g_j[3], mode=mode, cfg=TILED)
    dt = api.render_depth(*cam_t, (32, 48), g_t[0], g_t[1], g_t[3], mode=mode)
    # Depth features reach ~6: absolute 1e-5 on values of that size.
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=2e-6, atol=1e-5)


def test_render_matches_jax_pallas_interpret():
    scene = make_scene(6, views=1, g=256)
    jcfg = JaxCfg(mode="pallas", interpret=True, capacity=256, chunk=128, bin_chunk=128)
    out_j, out_t = render_both(scene, (32, 32), BG[:1], jcfg)
    assert int(np.asarray(out_j.overflow).sum()) == 0
    # The Pallas path routes features through 2-way bf16 splits (<= 2^-18
    # relative) and a log-space transmittance: 2e-5 absolute on colours.
    np.testing.assert_allclose(out_t.color.numpy(), np.asarray(out_j.color), atol=2e-5)


def test_bf16_precision_not_ported():
    scene = make_scene(7, views=1, g=16)
    cam_t, g_t = _args(scene, torch.from_numpy)
    with pytest.raises(NotImplementedError):
        api.render(*cam_t, (16, 16), torch.zeros(1, 3), *g_t, cfg=RasterizeConfig(precision="bf16"))
