"""The port's view-sharded decode (sp) against the JAX package's.

JAX runs `decode_splatting(mesh=make_mesh(dp=1, sp=2))` (shard_map over two
of the 8 virtual CPU devices that tests/conftest.py sets up); the port runs
two gloo ranks (transplat_tpu_torch.parallel.launch.spawn), each with its
slice of the Gaussians, on the same numpy scene as
`__graft_entry__.dryrun_multichip` draws it (here 2048 Gaussians, two
views at 64x64). Colours within 1e-5; the Gaussians' gradients (after the
reduce-scatter) within 5e-5 of the largest entry against jax.grad through
the naive oracle, the renderer's bound (tests/test_torch_grads.py), and
within rtol 1e-5 of the port's own unsharded decode, as
tests/test_multichip.py::test_sharded_decode_grads_match holds JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_grads import scaled
from transplat_tpu.model.decoder import DecoderCfg as JaxDecoderCfg
from transplat_tpu.model.decoder import decode_splatting as jax_decode
from transplat_tpu.model.types import Gaussians as JaxGaussians
from transplat_tpu.ops.rasterizer.api import RasterizeConfig as JaxCfg
from transplat_tpu.parallel.mesh import make_mesh as jax_make_mesh
from transplat_tpu_torch.model.decoder import decode_splatting
from transplat_tpu_torch.model.types import Gaussians
from transplat_tpu_torch.parallel import dryrun, launch

IMAGE = (64, 64)
FIELDS = ("means", "covariances", "harmonics", "opacities")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene():
    return dryrun.dryrun_scene(1, g=2048, views=2, seed=3)


@pytest.fixture(scope="module")
def port_ranks(scene):
    return launch.spawn(dryrun.decode_rank, 2, scene, 1, 2, IMAGE, "cpu", timeout_s=300)


def _jax_args(scene):
    gs = JaxGaussians(*(jnp.asarray(scene[k]) for k in FIELDS))
    return gs, [jnp.asarray(scene[k]) for k in ("extrinsics", "intrinsics", "near", "far")]


def test_sharded_decode_colours_match_jax(scene, port_ranks):
    mesh = jax_make_mesh(dp=1, sp=2, devices=jax.devices()[:2])
    gs, cams = _jax_args(scene)
    cfg = JaxDecoderCfg(rasterize=JaxCfg(mode="tiled", binning="fast", capacity=4096, chunk=128))
    out = jax.jit(lambda: jax_decode(gs, *cams, IMAGE, cfg=cfg, mesh=mesh))()
    assert int(np.asarray(out.overflow).sum()) == 0
    want = np.asarray(out.color)
    for r, rec in enumerate(port_ranks):
        assert rec["views"] == [r, r + 1] and rec["color"].shape == (1, 1, *IMAGE, 3)
        np.testing.assert_allclose(rec["color"].numpy(), want[:, r : r + 1], rtol=0, atol=1e-5)


def test_sharded_decode_gradients_match_jax_and_the_unsharded_decode(scene, port_ranks):
    mesh = jax_make_mesh(dp=1, sp=2, devices=jax.devices()[:2])
    gs, cams = _jax_args(scene)
    cfg = JaxDecoderCfg(rasterize=JaxCfg(mode="reference"))

    def loss(*fields):
        return jnp.sum(jax_decode(JaxGaussians(*fields), *cams, IMAGE, cfg=cfg, mesh=mesh).color ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*gs)
    # Each rank holds the gradient of its half of the Gaussians, summed over both ranks' views.
    got = {k: np.concatenate([rec["grads"][k].numpy() for rec in port_ranks], axis=1) for k in FIELDS}
    for k, w in zip(FIELDS, want):
        assert np.isfinite(got[k]).all(), k
        assert scaled(got[k], w) <= 5e-5, (k, scaled(got[k], w))

    leaves = Gaussians(*(torch.from_numpy(scene[k]).requires_grad_(True) for k in FIELDS))
    color = decode_splatting(leaves, *(torch.from_numpy(scene[k]) for k in ("extrinsics", "intrinsics", "near", "far")),
                             IMAGE).color
    (color**2).sum().backward()
    for k in FIELDS:
        np.testing.assert_allclose(got[k], getattr(leaves, k).grad.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def dry_run():
    return dryrun.dryrun_multichip(2, "cpu", timeout_s=300)


def test_dryrun_multichip_runs_on_the_cpu(dry_run):
    """dp = 1 x sp = 2: one full training step of the tiny configuration,
    then the sharded decode's forward and backward, on both ranks."""
    assert len(dry_run) == 2
    for rec in dry_run:
        assert (rec["dp"], rec["sp"]) == (1, 2)
        assert np.isfinite(rec["step"]["metrics"]["loss"]) and rec["step"]["metrics"]["grad_norm"] > 0
        assert rec["decode"]["grad_norm"] > 0
    assert dry_run[0]["step"]["metrics"] == dry_run[1]["step"]["metrics"]


def test_gaussians_stay_sliced_until_the_boundary(dry_run):
    """The counterpart of tests/test_multichip.py::test_gaussians_stay_sharded_until_boundary:
    in a training step each sp rank hands the decoder its g / 2 Gaussians and
    the step's one all-gather moves exactly the four fields of all g (b = 1,
    g = 2 x 64 x 64, 3 + 9 + 3 x 4 + 1 = 25 floats each: SH degree 1); its
    backward is one reduce-scatter of the same size."""
    one_gather = 1 * 2 * 64 * 64 * 25 * 4
    for rec in dry_run:
        traffic = rec["step"]["traffic"]
        assert traffic["all_gather"] == traffic["reduce_scatter"] == one_gather
    # The decode alone: 2048 Gaussians with SH degree 4 (3 x 25): 88 floats each.
    assert dry_run[0]["decode"]["traffic"] == {"all_gather": 4096 * 88 * 4, "reduce_scatter": 4096 * 88 * 4}
