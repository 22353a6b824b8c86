"""Port deformable sampling (transplat_tpu_torch.ops.deform) vs the JAX package.

On the CPU `deform_sample_scores` runs the plain version of kernel K5 (the
gather + weights); it is held against the JAX Pallas kernel in interpret
mode at shapes that kernel supports, against JAX's gather oracle at a shape
it does not, and with locations far outside the map. The CUDA kernel is held
against the plain version on the card (`cuda` test, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transplat_tpu.ops import deform as jax_deform
from transplat_tpu_torch.ops import deform

# Sums of 4P bilinear terms of O(1) scores, float32, in another order than
# the JAX kernel's separable matmuls: 2e-5 (the JAX suite's own bound for
# its Pallas kernel against its gather oracle, tests/test_ops_sampling.py).
ATOL = 2e-5


def _case(q, d, p, h, w, seed=0, lo=-0.05, hi=1.05):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((q, h * w)).astype(np.float32)
    loc = rng.uniform(lo, hi, (q, d, p, 2)).astype(np.float32)
    logits = rng.standard_normal((q, d, p)).astype(np.float32)
    aw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return scores, loc, aw.astype(np.float32)


def _port(scores, loc, aw, hw):
    return deform.deform_sample_scores(
        torch.from_numpy(scores), hw, torch.from_numpy(loc), torch.from_numpy(aw)
    ).numpy()


@pytest.mark.parametrize("q,d,p", [(64, 32, 4), (64, 128, 1)])
def test_scores_match_jax_pallas_interpret(q, d, p):
    from transplat_tpu.ops.deform_pallas import supported

    assert supported(q, d, p, 8, 8)
    scores, loc, aw = _case(q, d, p, 8, 8, seed=q + d + p)
    ref = jax_deform.deform_sample_scores(
        jnp.asarray(scores), (8, 8), jnp.asarray(loc), jnp.asarray(aw), impl="pallas"
    )
    np.testing.assert_allclose(_port(scores, loc, aw, (8, 8)), np.asarray(ref), atol=ATOL)


def test_scores_match_jax_gather_at_unsupported_shape():
    from transplat_tpu.ops.deform_pallas import supported

    q, d, p, h, w = 37, 5, 3, 7, 11
    assert not supported(q, d, p, h, w)
    scores, loc, aw = _case(q, d, p, h, w, seed=3)
    ref = jax_deform.deform_sample_scores_gather(jnp.asarray(scores), (h, w), jnp.asarray(loc), jnp.asarray(aw))
    np.testing.assert_allclose(_port(scores, loc, aw, (h, w)), np.asarray(ref), atol=ATOL)


def test_scores_out_of_range_and_grid_aligned():
    """Locations far outside [0, 1] give 0; pixel-centre locations (zero
    offsets, as a freshly initialised UVCrossAttention samples) and exact
    corner boundaries pick single samples."""
    q, d, p, h, w = 16, 8, 2, 8, 8
    scores, loc, aw = _case(q, d, p, h, w, seed=4, lo=-3.0, hi=4.0)
    centres = (np.arange(8, dtype=np.float32) + 0.5) / 8
    loc[:, :2, :, 0] = centres[np.arange(q) % 8, None, None]
    loc[:, :2, :, 1] = centres[(np.arange(q) * 3) % 8, None, None]
    loc[:, 2, :, :] = 0.0  # half a pixel outside: one quarter-weight corner
    loc[:, 3, :, :] = 1e4  # far outside
    ref = jax_deform.deform_sample_scores_gather(jnp.asarray(scores), (h, w), jnp.asarray(loc), jnp.asarray(aw))
    out = _port(scores, loc, aw, (h, w))
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    np.testing.assert_array_equal(out[:, 3], 0.0)


def test_scores_pair_batch_dim():
    """A leading pair dim (the JAX package vmaps over directed view pairs)."""
    scores, loc, aw = _case(32, 16, 4, 8, 8, seed=5)
    s2, l2, a2 = np.stack([scores, 0.5 * scores]), np.stack([loc, 1.0 - loc]), np.stack([aw, aw])
    ref = jax.vmap(lambda s, l, a: jax_deform.deform_sample_scores(s, (8, 8), l, a, impl="xla"))(
        jnp.asarray(s2), jnp.asarray(l2), jnp.asarray(a2)
    )
    np.testing.assert_allclose(_port(s2, l2, a2, (8, 8)), np.asarray(ref), atol=ATOL)


def test_vectors_match_jax_xla():
    rng = np.random.default_rng(6)
    hw, q, p, c = (8, 8), 64, 4, 16
    value = rng.standard_normal((2, 64, c)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (2, q, p, 2)).astype(np.float32)
    aw = rng.random((2, q, p)).astype(np.float32)
    ref = jax.vmap(lambda v, l, a: jax_deform.deform_sample_vectors(v, hw, l, a, impl="xla"))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(aw)
    )
    out = deform.deform_sample_vectors(torch.from_numpy(value), hw, torch.from_numpy(loc), torch.from_numpy(aw))
    # JAX sums the 4P terms as one dense (Q, HW) x (HW, C) matmul; 1e-5.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
