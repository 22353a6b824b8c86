"""The port's deformable value sampler (K7 / K8) vs the JAX package, on the CPU.

`deform_sample_vectors` is an autograd.Function: on the CPU its forward is
`deform_sample_vectors_plain` and its backward `deform_sample_vectors_bwd_plain`,
the plain versions of the CUDA kernels, through the plumbing the card takes
with the kernels swapped in. Forward and gradients are held against

  * the JAX package on the same numpy inputs: `impl="xla"` (the one-hot
    matmul at HIGHEST precision) and `impl="pallas"` (the TPU kernels in
    interpret mode, where `vectors_supported` takes the shape), and
  * `torch.autograd` of the plain forward.

Gradient errors are measured relative to the largest entry of the gradient
compared (`scaled`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transplat_tpu.ops import deform as jax_deform
from transplat_tpu.ops.deform_pallas import vectors_supported
from transplat_tpu_torch.ops import deform

# An output entry is a sum of 4 P float32 products and a gradient entry a sum
# of up to 4 P C of them, taken in another order than JAX's matmuls: 2e-6
# (forward: absolute, on values of order 1; gradients: of the largest entry),
# the JAX suite's own bound between its Pallas and XLA backward
# (tests/test_ops_sampling.py::test_gradients_match_xla_vjp).
TOL = 2e-6


def scaled(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _case(q, p, h, w, c, seed, lo=-0.05, hi=1.05, boundaries=False):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((h * w, c)).astype(np.float32)
    loc = rng.uniform(lo, hi, (q, p, 2)).astype(np.float32)
    if boundaries:  # exact corner boundaries: wx or wy is 0 and floor() sits on its step
        loc[: q // 2] = np.round(loc[: q // 2] * w) / w
    aw = rng.random((q, p)).astype(np.float32)
    aw /= aw.sum(-1, keepdims=True)
    cot = rng.standard_normal((q, c)).astype(np.float32)
    return value, loc, aw, cot


def _port_grads(fn, value, loc, aw, cot, hw):
    leaves = [torch.from_numpy(a).clone().requires_grad_(True) for a in (value, loc, aw)]
    out = fn(leaves[0], hw, leaves[1], leaves[2])
    return [g.numpy() for g in torch.autograd.grad(out, leaves, torch.from_numpy(cot))]


def _jax_fn(impl, hw):
    return lambda v, l, a: jax_deform.deform_sample_vectors(v, hw, l, a, impl=impl)  # noqa: E731


PALLAS_SHAPES = [
    # q, p, h, w, c, kw
    (64, 4, 16, 16, 128, {}),
    (64, 1, 16, 16, 128, {}),
    (64, 4, 16, 16, 128, {"boundaries": True}),
    (64, 4, 16, 16, 128, {"lo": -0.4, "hi": 1.4}),  # a good share outside the map
]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("q,p,h,w,c,kw", PALLAS_SHAPES)
def test_forward_matches_jax(q, p, h, w, c, kw, impl):
    assert vectors_supported(q, p, h, w, c)
    value, loc, aw, _ = _case(q, p, h, w, c, seed=q + p + c, **kw)
    ref = np.asarray(_jax_fn(impl, (h, w))(jnp.asarray(value), jnp.asarray(loc), jnp.asarray(aw)))
    got = deform.deform_sample_vectors(torch.from_numpy(value), (h, w), torch.from_numpy(loc), torch.from_numpy(aw))
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= TOL


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_with_pair_dim_matches_vmapped_jax(impl):
    """The port writes the directed-pair dim out; the JAX package vmaps over it."""
    q, p, h, w, c = 64, 4, 16, 16, 128
    cases = [_case(q, p, h, w, c, seed=s, boundaries=bool(s)) for s in range(2)]
    value, loc, aw = (np.stack([cs[i] for cs in cases]) for i in range(3))
    ref = np.asarray(jax.vmap(_jax_fn(impl, (h, w)))(jnp.asarray(value), jnp.asarray(loc), jnp.asarray(aw)))
    got = deform.deform_sample_vectors(torch.from_numpy(value), (h, w), torch.from_numpy(loc), torch.from_numpy(aw))
    assert got.shape == (2, q, c)
    assert np.abs(got.numpy() - ref).max() <= TOL


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("q,p,h,w,c,kw", PALLAS_SHAPES)
def test_gradients_match_jax(q, p, h, w, c, kw, impl):
    value, loc, aw, cot = _case(q, p, h, w, c, seed=2 * q + p, **kw)
    fn = _jax_fn(impl, (h, w))
    ref = jax.grad(lambda v, l, a: jnp.sum(fn(v, l, a) * cot), argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(aw)
    )
    got = _port_grads(deform.deform_sample_vectors, value, loc, aw, cot, (h, w))
    for name, a, b in zip(("value", "loc", "weights"), got, ref):
        assert scaled(a, b) <= TOL, (name, scaled(a, b))


@pytest.mark.parametrize(
    "q,p,h,w,c,kw",
    [
        (20, 4, 5, 7, 16, {}),  # shapes the TPU kernel refuses: C 16, a 5x7 map
        (20, 1, 5, 7, 16, {"boundaries": True}),
        (9, 11, 4, 4, 6, {"lo": -0.5, "hi": 1.5}),
        (12, 3, 7, 9, 130, {"boundaries": True, "lo": -0.2, "hi": 1.2}),
    ],
)
def test_function_matches_autograd_of_plain_on_any_shape(q, p, h, w, c, kw):
    """Two leading batch dims, shapes `vectors_supported` refuses: the
    Function (plain forward + hand-written plain backward) against the gather
    oracle and its autograd, and the JAX XLA form per batch entry."""
    assert not vectors_supported(q, p, h, w, c)
    cases = [_case(q, p, h, w, c, seed=s, **kw) for s in range(4)]
    value, loc, aw, cot = (np.stack([cs[i] for cs in cases]).reshape(2, 2, *cases[0][i].shape) for i in range(4))
    auto = _port_grads(deform.deform_sample_vectors_plain, value, loc, aw, cot, (h, w))
    got = _port_grads(deform.deform_sample_vectors, value, loc, aw, cot, (h, w))
    for name, a, b in zip(("value", "loc", "weights"), got, auto):
        assert a.shape == b.shape
        assert scaled(a, b) <= TOL, (name, scaled(a, b))
    t = [torch.from_numpy(a) for a in (value, loc, aw)]
    out = deform.deform_sample_vectors(t[0], (h, w), t[1], t[2])
    assert torch.equal(out, deform.deform_sample_vectors_plain(t[0], (h, w), t[1], t[2]))
    ref = np.asarray(_jax_fn("xla", (h, w))(*(jnp.asarray(a[1, 0]) for a in (value, loc, aw))))
    assert np.abs(out[1, 0].numpy() - ref).max() <= TOL


def test_outside_the_map_gradients_are_exactly_zero():
    """Points just outside keep one row or column of corners; far outside
    every corner is padding: output and gradients exactly 0, never NaN, also
    where the float -> int conversion would overflow."""
    h, w, c = 6, 8, 16
    value, _, _, _ = _case(4, 1, h, w, c, seed=0)
    loc = np.array(
        [
            [[-0.01, 0.5], [1.01, 0.5]],  # just outside in x: the inner column still counts
            [[0.5, -0.01], [0.5, 1.01]],  # just outside in y
            [[-3.0, 0.5], [0.5, 7.0]],  # far outside
            [[1e9, -1e9], [-4e12, 4e12]],  # beyond int32
        ],
        np.float32,
    )
    aw = np.full((4, 2), 0.5, np.float32)
    cot = np.ones((4, c), np.float32)
    got = _port_grads(deform.deform_sample_vectors, value, loc, aw, cot, (h, w))
    auto = _port_grads(deform.deform_sample_vectors_plain, value, loc, aw, cot, (h, w))
    for a, b in zip(got, auto):
        assert np.isfinite(a).all()
        assert scaled(a, b) <= TOL
    d_value, d_loc, d_aw = got
    assert np.abs(d_loc[:2]).max() > 0 and np.abs(d_aw[:2]).max() > 0
    assert np.abs(d_loc[2:]).max() == 0.0 and np.abs(d_aw[2:]).max() == 0.0
    out = deform.deform_sample_vectors(torch.from_numpy(value), (h, w), torch.from_numpy(loc), torch.from_numpy(aw))
    assert float(out[2:].abs().max()) == 0.0


def test_two_points_on_the_same_corner_add_up():
    """Both points of a query on one pixel centre: that row's d_value gets both weights."""
    h, w, c = 4, 4, 8
    value = np.arange(h * w * c, dtype=np.float32).reshape(h * w, c) / 10.0
    centre = np.array([(1 + 0.5) / w, (2 + 0.5) / h], np.float32)  # pixel (y 2, x 1): wx = wy = 0
    loc = np.stack([centre, centre])[None]  # (1, 2, 2)
    aw = np.array([[0.3, 0.7]], np.float32)
    cot = np.ones((1, c), np.float32)
    out = deform.deform_sample_vectors(torch.from_numpy(value), (h, w), torch.from_numpy(loc), torch.from_numpy(aw))
    np.testing.assert_allclose(out.numpy()[0], value[2 * w + 1], rtol=1e-6)
    d_value, _, d_aw = _port_grads(deform.deform_sample_vectors, value, loc, aw, cot, (h, w))
    expected = np.zeros_like(value)
    expected[2 * w + 1] = 1.0
    np.testing.assert_allclose(d_value, expected, atol=1e-6)
    np.testing.assert_allclose(d_aw[0], [value[2 * w + 1].sum()] * 2, rtol=1e-6)


def test_function_records_a_graph_and_honours_needs_input_grad():
    value, loc, aw, cot = _case(8, 2, 4, 4, 8, seed=3)
    v = torch.from_numpy(value).requires_grad_(True)
    out = deform.deform_sample_vectors(v, (4, 4), torch.from_numpy(loc), torch.from_numpy(aw))
    assert out.grad_fn is not None
    (g,) = torch.autograd.grad(out, [v], torch.from_numpy(cot))
    assert g.shape == v.shape
    with pytest.raises(ValueError, match="rows"):  # the CUDA wrappers' shape check
        deform._check_vectors_args(torch.zeros(5, 3), (2, 2), torch.zeros(1, 1, 2), torch.zeros(1, 1))
