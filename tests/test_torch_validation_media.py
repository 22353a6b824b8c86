"""Validation media of the port (visualization/validation_3d.py, the Trainer's
validation output) and Benchmarker.trace, against the JAX package.

  * render_orthographic: the same numpy Gaussians through JAX's and the
    port's (the port's plain K1 / K3 here), at the Trainer's three
    axis-aligned looks: a tiny field of view (0.1 deg), the camera ~573x the
    cloud's extent away, scale_invariant=False. Tolerance ORTHO_ATOL.
  * draw_cameras: pixel for pixel against JAX's on the same image and
    cameras, both with a camera that frames the frusta and with the
    Trainer's own look camera (whose tiny-fov projection throws the frusta
    far outside the image, so the lines land clipped on its border).
  * Trainer.validate from the same seeded JAX variables (loaded into the
    port with load_jax_variables): the same three file names, the grid's shape, its
    context and target rows equal, the prediction row and the 14 wobble
    frames within RENDER_SHARE / RENDER_MAX (the image is a step function of
    the Gaussians, which agree to 1e-3: tests/test_torch_encoder.py; measured
    0.55% / 0.62% of the values beyond 1e-4, max 8.9e-4 / 8.3e-4), the
    projections within the same bound (0.004%, max 5.6e-4), the .mp4 read
    back as 14 frames; save_media=False writes the grid alone.
    The port writes into `<save_dir>/../local` by default, where the JAX
    Trainer writes into `outputs/local` under the working directory.
  * Benchmarker.trace writes a trace file for a few CPU ops.

Tiny widths (the tiny encoder of tests/test_torch_fit_eval.py), 32x32.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fit_eval import SHAPE, TINY_ENCODER, golden, tiny_cfg
from test_torch_modules import random_variables
from test_torch_rasterizer import make_scene
from transplat_tpu import config as jax_config
from transplat_tpu.model.types import Gaussians as JGaussians
from transplat_tpu.ops.rasterizer.api import RasterizeConfig as JaxCfg
from transplat_tpu.visualization import validation_3d as jax_v3d
from transplat_tpu_torch.convert import load_jax_variables
from transplat_tpu_torch.model.types import Gaussians
from transplat_tpu_torch.training import Trainer, create_train_state
from transplat_tpu_torch.utils.image_io import load_video
from transplat_tpu_torch.visualization import validation_3d

# Measured <= 1.1e-6 on these scenes: the same Gaussians render to float32
# rounding even ~573x the extent away.
ORTHO_ATOL = 1e-4
# End to end from the same parameters (tests/test_torch_encoder.py): 98% of
# the colour values within 1e-4, all within 0.05.
RENDER_SHARE, RENDER_MAX = 0.02, 0.05
# JAX's tiled renderer at a capacity that drops no pair at these sizes.
JAX_RASTER = dict(mode="tiled", binning="fast", capacity=4096, chunk=128)
VIEW_FX = 0.5 / np.tan(np.radians(0.05))  # the Trainer's look intrinsics
CTX_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


def _looks(means):
    """The Trainer's three looks at the 2-98 percentile box of `means`."""
    lo, hi = np.percentile(means, [2, 98], axis=0)
    center, extent = (lo + hi) / 2, float((hi - lo).max()) + 1e-3
    looks = []
    for rot in (np.eye(3), np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0.0]]), np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0.0]])):
        e = np.eye(4)
        e[:3, :3] = rot
        e[:3, 3] = center - rot[:, 2] * extent
        looks.append(e)
    return np.stack(looks), extent


@pytest.mark.parametrize("seed,g", [(0, 300), (1, 2000), (2, 5000)])
def test_render_orthographic_matches_jax(seed, g):
    scene = make_scene(seed, views=1, g=g, stretch=(2.0, 4.0))
    looks, extent = _looks(scene["means"][0])
    port_looks, port_extent = validation_3d.axis_looks(scene["means"][0])
    assert port_extent == extent and np.array_equal(np.stack([e for _, e in port_looks]), looks)
    gs = [np.ascontiguousarray(np.broadcast_to(scene[k], (3, *scene[k].shape[1:])))
          for k in ("means", "covariances", "sh", "opacities")]
    args = (extent, extent, 0.0, 2.0 * extent, (128, 128))
    want = np.asarray(jax_v3d.render_orthographic(
        JGaussians(*map(jnp.asarray, gs)), jnp.asarray(looks), *args, cfg=JaxCfg(**{**JAX_RASTER, "capacity": 8192})
    ))
    got = validation_3d.render_orthographic(Gaussians(*map(torch.from_numpy, gs)), torch.as_tensor(looks, dtype=torch.float32), *args)
    assert got.shape == (3, 128, 128, 3) and got.dtype == torch.float32
    assert want.max() > 0.1  # the cloud is in view
    np.testing.assert_allclose(got.numpy(), want, atol=ORTHO_ATOL)


def test_draw_cameras_pixel_for_pixel():
    rng = np.random.default_rng(3)
    image = rng.random((64, 80, 3)).astype(np.float32)
    cams = np.tile(np.eye(4), (5, 1, 1))
    cams[:, 0, 3] = np.linspace(-0.6, 0.6, 5)
    cams[:, 2, 3] = rng.uniform(1.5, 2.5, 5)
    cams[4, 2, 3] = -3.0  # behind the viewing camera: not drawn
    framing = np.eye(4)
    framing[2, 3] = -2.0
    intr = np.array([[0.6, 0, 0.5], [0, 0.7, 0.5], [0, 0, 1.0]])
    want = jax_v3d.draw_cameras(image, cams, framing, intr, frustum_depth=1.0)
    got = validation_3d.draw_cameras(image, cams, framing, intr, frustum_depth=1.0)
    np.testing.assert_array_equal(got, want)
    drawn = (got != image).any(-1)
    assert 100 < drawn.sum() and not drawn[:, 0].all()  # frusta inside the image, not border lines
    # The Trainer's look camera and tiny-fov intrinsics: the lines clip onto the border.
    looks, extent = _looks(rng.uniform(-1.0, 1.0, (500, 3)))
    k = np.array([[VIEW_FX, 0, 0.5], [0, VIEW_FX, 0.5], [0, 0, 1.0]])
    for look in looks:
        want = jax_v3d.draw_cameras(image, cams, look, k, frustum_depth=0.2 * extent)
        np.testing.assert_array_equal(validation_3d.draw_cameras(image, cams, look, k, frustum_depth=0.2 * extent), want)


@pytest.fixture(scope="module")
def trainer_pair(tmp_path_factory):
    """A JAX Trainer and a port Trainer at the tiny width, both at step 3, and
    a state of each from the same seeded JAX variables."""
    from transplat_tpu.model.encoder import EncoderTranSplat as JEnc
    from transplat_tpu.training.trainer import Trainer as JTrainer

    tmp = tmp_path_factory.mktemp("validate")
    jcfg = jax_config.load_config(
        "re10k", encoder=dict(TINY_ENCODER), dataset=dict(image_shape=SHAPE), decoder=dict(rasterize=JAX_RASTER),
        loss=dict(lpips_weight=0.0), checkpointing=dict(save_dir=str(tmp / "jax" / "checkpoints")),
    )
    batch = golden()
    variables = random_variables(JEnc(jcfg.encoder), *(batch["context"][k] for k in CTX_KEYS), seed=41)
    variables["params"]["depth_predictor"]["to_disparity_2"]["kernel"][..., 0] *= 0.01  # depths off the 1/far clip
    jax_trainer = JTrainer(jcfg, log_fn=lambda *a: None)
    jax_state = types.SimpleNamespace(params=variables["params"], batch_stats=variables["batch_stats"])
    cfg = tiny_cfg(tmp / "port")
    trainer = Trainer(cfg, log_fn=lambda m: None, device="cpu")
    state = create_train_state(cfg.encoder, trainer.optimizer, None, device="cpu", seed=0)
    load_jax_variables(state.encoder, variables)
    state.encoder.eval()
    jax_trainer.global_step = trainer.global_step = 3
    return jax_trainer, jax_state, trainer, state, batch, tmp


def _capture(monkeypatch, module, name, store):
    real = getattr(module, name)

    def wrapper(data, path, *args, **kwargs):
        store[path.name] = (data, args, kwargs)
        return real(data, path, *args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)


def _rows(grid):
    """The three labelled rows of a validation grid (24-px label, 8-px gap)."""
    h = (grid.shape[0] - 2 * 8) // 3
    return [grid[i * (h + 8): i * (h + 8) + h] for i in range(3)]


def test_validate_media_match_jax(trainer_pair, monkeypatch):
    import transplat_tpu.utils.image_io as jax_io
    import transplat_tpu_torch.training.trainer as port_trainer

    jax_trainer, jax_state, trainer, state, batch, tmp = trainer_pair
    jax_files, port_files = {}, {}
    for name in ("save_image", "save_video"):
        _capture(monkeypatch, jax_io, name, jax_files)
        _capture(monkeypatch, port_trainer, name, port_files)
    want = jax_trainer.validate(jax_state, batch, out_dir=str(tmp / "jax" / "local"))
    got = trainer.validate(state, batch)

    names = ["projections_00000003.png", "validation_00000003.png", "wobble_00000003.mp4"]
    assert sorted(jax_files) == sorted(port_files) == names
    out = tmp / "port" / "local"  # beside metrics.jsonl, under the run's directory
    assert trainer.media_dir == out and sorted(p.name for p in out.iterdir()) == names
    assert set(got) == {"val_psnr"} and abs(got["val_psnr"] - want["val_psnr"]) < 0.05

    grid, jgrid = port_files["validation_00000003.png"][0], np.asarray(jax_files["validation_00000003.png"][0])
    assert grid.shape == jgrid.shape == (3 * (24 + SHAPE[0]) + 2 * 8, 2 * SHAPE[1] + 8, 3)
    (ctx, gt, pred), (jctx, jgt, jpred) = _rows(grid), _rows(jgrid)
    np.testing.assert_array_equal(ctx, jctx)
    np.testing.assert_array_equal(gt, jgt)
    diff = np.abs(pred[24:] - jpred[24:])  # below the label, whose PSNR may round another way
    assert np.mean(diff > 1e-4) < RENDER_SHARE and diff.max() < RENDER_MAX, (np.mean(diff > 1e-4), diff.max())

    proj, jproj = port_files["projections_00000003.png"][0], np.asarray(jax_files["projections_00000003.png"][0])
    assert proj.shape == jproj.shape == (24 + 128, 3 * 128 + 2 * 8, 3)
    np.testing.assert_array_equal(proj[:24], jproj[:24])  # the labels
    diff = np.abs(proj[24:] - jproj[24:])
    assert np.mean(diff > 1e-4) < RENDER_SHARE and diff.max() < RENDER_MAX, (np.mean(diff > 1e-4), diff.max())

    frames, args, kwargs = port_files["wobble_00000003.mp4"]
    jframes, jargs, jkwargs = jax_files["wobble_00000003.mp4"]
    assert kwargs == jkwargs == {"fps": 7} and args == jargs == ()
    assert len(frames) == len(jframes) == 14 and frames[0].shape == (*SHAPE, 3)
    diff = np.abs(np.stack(frames) - np.stack([np.asarray(f) for f in jframes]))
    assert np.mean(diff > 1e-4) < RENDER_SHARE and diff.max() < RENDER_MAX, (np.mean(diff > 1e-4), diff.max())
    video = load_video(out / "wobble_00000003.mp4")
    assert video.shape == (14, *SHAPE, 3)


def test_validate_without_media_writes_the_grid_only(trainer_pair, tmp_path):
    _, _, trainer, state, batch, _ = trainer_pair
    got = trainer.validate(state, batch, out_dir=tmp_path / "grid_only", save_media=False)
    assert np.isfinite(got["val_psnr"])
    assert sorted(p.name for p in (tmp_path / "grid_only").iterdir()) == ["validation_00000003.png"]


def test_benchmarker_trace_writes_a_trace(tmp_path):
    from transplat_tpu_torch.utils.benchmarker import Benchmarker

    b = Benchmarker(device="cpu")
    with b.trace(tmp_path / "trace") as prof:
        x = torch.randn(32, 32)
        (x @ x).relu().sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert "aten::mm" in {e.key for e in prof.key_averages()}
