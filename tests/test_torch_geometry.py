"""Port geometry (transplat_tpu_torch.geometry) vs the JAX package, on the
same numpy inputs. Tolerance 1e-5: float32 results of O(1) magnitude from a
few products and sums, taken in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transplat_tpu import geometry as jg
from transplat_tpu.geometry import epipolar as jep
from transplat_tpu_torch import geometry as tg
from transplat_tpu_torch.geometry import epipolar as tep

ATOL = 1e-5


def _close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _cams(rng, n=3):
    intr = np.tile(np.array([[1.1, 0, 0.48], [0, 1.2, 0.52], [0, 0, 1.0]], np.float32), (n, 1, 1))
    extr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    extr[:, :3, 3] = rng.uniform(-0.5, 0.5, (n, 3))
    ang = rng.uniform(-0.3, 0.3, n)
    extr[:, 0, 0] = extr[:, 2, 2] = np.cos(ang)
    extr[:, 0, 2] = np.sin(ang)
    extr[:, 2, 0] = -np.sin(ang)
    return intr, extr


def _rot(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    from transplat_tpu_torch.geometry.gaussians import quaternion_to_matrix

    return quaternion_to_matrix(torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True))).numpy()


def test_projection_functions():
    rng = _rng(1)
    intr, extr = _cams(rng)
    _close(tg.get_fov(torch.from_numpy(intr)), jg.get_fov(jnp.asarray(intr)))
    _close(tg.unnormalize_intrinsics(torch.from_numpy(intr), (48, 64)), jg.unnormalize_intrinsics(jnp.asarray(intr), (48, 64)))
    ct, it = tg.sample_image_grid((6, 10))
    cj, ij = jg.sample_image_grid((6, 10))
    _close(ct, cj)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    coords = rng.random((3, 20, 2)).astype(np.float32)
    ot, dt = tg.get_world_rays(torch.from_numpy(coords), torch.from_numpy(extr)[:, None], torch.from_numpy(intr)[:, None])
    oj, dj = jg.get_world_rays(jnp.asarray(coords), jnp.asarray(extr)[:, None], jnp.asarray(intr)[:, None])
    _close(ot, oj)
    _close(dt, dj)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_and_rotate_sh(degree):
    rng = _rng(degree)
    n = (degree + 1) ** 2
    sh = rng.standard_normal((50, 3, n)).astype(np.float32)
    dirs = rng.standard_normal((50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    _close(tg.eval_sh(torch.from_numpy(sh), torch.from_numpy(dirs)), jg.eval_sh(jnp.asarray(sh), jnp.asarray(dirs)))
    rot = _rot(rng, 50)
    rt = tg.rotate_sh(torch.from_numpy(sh), torch.from_numpy(rot)[:, None])
    rj = jg.rotate_sh(jnp.asarray(sh), jnp.asarray(rot)[:, None])
    # Degree-4 rotation matrices come from a 4-step recursion of 3x3 products.
    _close(rt, rj, atol=1e-5 * (degree + 1))


def test_covariance():
    rng = _rng(5)
    scale = rng.uniform(0.01, 2.0, (40, 3)).astype(np.float32)
    quat = rng.standard_normal((40, 4)).astype(np.float32)
    _close(tg.quaternion_to_matrix(torch.from_numpy(quat)), jg.quaternion_to_matrix(jnp.asarray(quat)))
    # Covariances reach ~4: relative 1e-5 on top of the absolute bound.
    _close(tg.build_covariance(torch.from_numpy(scale), torch.from_numpy(quat)),
           jg.build_covariance(jnp.asarray(scale), jnp.asarray(quat)), rtol=1e-5)


def test_epipolar_grid():
    rng = _rng(6)
    intr, extr = _cams(rng, 2)
    intr_px = intr.copy()
    intr_px[:, 0] *= 16
    intr_px[:, 1] *= 12
    near = np.full((2,), 1.0, np.float32)
    far = np.full((2,), 100.0, np.float32)
    disp_t = tep.inverse_depth_candidates(torch.from_numpy(near), torch.from_numpy(far), 8)
    disp_j = jep.inverse_depth_candidates(jnp.asarray(near), jnp.asarray(far), 8)
    _close(disp_t, disp_j, rtol=1e-6)
    rel_t = tep.relative_pose(torch.from_numpy(extr[:1]), torch.from_numpy(extr[1:]))
    rel_j = jep.relative_pose(jnp.asarray(extr[:1]), jnp.asarray(extr[1:]))
    _close(rel_t, rel_j)
    gt = tep.epipolar_sample_grid(torch.from_numpy(intr_px[:1]), rel_t, 1.0 / disp_t[:1], 12, 16)
    gj = jep.epipolar_sample_grid(jnp.asarray(intr_px[:1]), rel_j, 1.0 / disp_j[:1], 12, 16)
    # Locations reach ~10 (points projected far outside the view): relative 1e-5.
    _close(gt, gj, rtol=1e-5)
