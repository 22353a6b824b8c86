"""The port's training step (losses, LPIPS, schedule, clip + Adam, train mode)
vs the JAX package, on the CPU at a tiny width.

Inputs and weights are made with numpy and handed to both packages
(`load_jax_variables`); gradients, BatchNorm statistics and parameters come
back in the JAX tree layout (`to_jax_tree`) and are compared leaf by leaf.
The JAX train step hard-codes dropout on, so the whole-step test composes
the JAX loss itself from the package's own parts with `deterministic=True`.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_encoder import _tiny_cfgs
from test_torch_modules import random_variables
from transplat_tpu_torch.convert import load_jax_variables, to_jax_tree
from transplat_tpu_torch.dataset import synthetic_batch
from transplat_tpu_torch.inference import re10k_decoder_cfg
from transplat_tpu_torch.loss import LPIPS, LossCfg, compute_losses, depth_smoothness_loss
from transplat_tpu_torch.training import create_train_state, make_lr_schedule, make_optimizer, make_train_step
from transplat_tpu_torch.training.step import loss_and_grads

CONTEXT_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


def flat(tree, prefix=()):
    """{path tuple: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# (c) losses and LPIPS
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lpips_pair():
    from transplat_tpu.loss.vgg import LPIPS as JLPIPS

    jl = JLPIPS()
    zeros = np.zeros((1, 32, 32, 3), np.float32)
    params = random_variables(jl, zeros, zeros, seed=5)["params"]
    port = LPIPS(device="cpu")
    load_jax_variables(port, {"params": params})
    return jl, params, port


def test_lpips_value_and_input_gradient_match_jax(lpips_pair):
    jl, params, port = lpips_pair
    rng = np.random.default_rng(0)
    a, b = rng.random((2, 3, 32, 32, 3), np.float32)
    ref, ref_grad = jax.value_and_grad(lambda x: jnp.sum(jl.apply({"params": params}, x, jnp.asarray(b))))(jnp.asarray(a))
    x = torch.from_numpy(a).requires_grad_(True)
    out = port(x, torch.from_numpy(b))
    assert out.shape == (3,)
    (grad,) = torch.autograd.grad(out.sum(), x)
    # 13 float32 convolutions summed in another order: 1e-5 relative on the
    # distances, 1e-4 of the largest entry on the input gradient.
    np.testing.assert_allclose(float(out.detach().sum()), float(ref), rtol=1e-5)
    assert np.abs(grad.numpy() - np.asarray(ref_grad)).max() <= 1e-4 * np.abs(np.asarray(ref_grad)).max()
    assert not any(p.requires_grad for p in port.parameters())  # frozen


@pytest.mark.parametrize("step,after", [(0, 0), (3, 5), (5, 5), (9, 5)])
def test_compute_losses_match_jax_with_lpips_gate(lpips_pair, step, after):
    from transplat_tpu.loss.losses import LossCfg as JLossCfg
    from transplat_tpu.loss.losses import compute_losses as jcompute

    jl, params, port = lpips_pair
    rng = np.random.default_rng(step)
    pred, target = rng.random((2, 1, 2, 32, 32, 3), np.float32)

    def jloss(p):
        total, parts = jcompute(
            JLossCfg(lpips_apply_after_step=after), p, jnp.asarray(target), jnp.asarray(step),
            lpips_fn=lambda x, y: jl.apply({"params": params}, x, y),
        )
        return total, parts

    (ref, ref_parts), ref_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(pred))
    x = torch.from_numpy(pred).requires_grad_(True)
    total, parts = compute_losses(LossCfg(lpips_apply_after_step=after), x, torch.from_numpy(target), step, lpips_fn=port)
    (grad,) = torch.autograd.grad(total, x)
    total, parts = total.detach(), {k: v.detach() for k, v in parts.items()}
    np.testing.assert_allclose(float(total), float(ref), rtol=1e-5)
    assert set(parts) == set(ref_parts) == {"mse", "lpips"}  # LPIPS is reported before the gate opens, too
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(ref_parts[k]), rtol=1e-5)
    gated = step < after
    assert np.isclose(float(total), float(parts["mse"])) == gated
    assert np.abs(grad.numpy() - np.asarray(ref_grad)).max() <= 1e-4 * np.abs(np.asarray(ref_grad)).max()


@pytest.mark.parametrize("sigma,second", [(None, False), (0.5, False), (0.5, True)])
def test_depth_smoothness_matches_jax(sigma, second):
    from transplat_tpu.loss.losses import depth_smoothness_loss as jdepth

    rng = np.random.default_rng(1)
    depth = rng.uniform(1.0, 10.0, (1, 2, 16, 20)).astype(np.float32)
    image = rng.random((1, 2, 16, 20, 3), np.float32)
    ref = jdepth(jnp.asarray(depth), jnp.asarray(image), sigma, second)
    got = depth_smoothness_loss(torch.from_numpy(depth), torch.from_numpy(image), sigma, second)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


# ---------------------------------------------------------------------------
# (d) the learning-rate schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cosine", [True, False])
@pytest.mark.parametrize("max_steps", [300_001, 1000])
def test_lr_schedule_matches_optax(cosine, max_steps):
    from transplat_tpu.training.schedule import make_lr_schedule as jmake

    ref = jmake(2e-4, max_steps, cosine=cosine, warm_up_steps=2000)
    got = make_lr_schedule(2e-4, max_steps, cosine=cosine, warm_up_steps=2000)
    warm_up_end = int(0.01 * (max_steps + 10)) if cosine else 2000
    steps = [0, 1, warm_up_end - 1, warm_up_end, warm_up_end + 1, max_steps // 2, max_steps - 1, max_steps, max_steps + 10, max_steps + 500]
    for step in steps:
        # optax evaluates in float32 (near the end its 1 + cos cancels to ~1e-7
        # of the peak value: atol 2e-11); the port in Python floats.
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=2e-5, atol=2e-11, err_msg=str(step))
    assert got(warm_up_end) == pytest.approx(2e-4)


# ---------------------------------------------------------------------------
# (e) clip + Adam
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad_scale", [10.0, 1e-3])  # clipped, not clipped
def test_clip_adam_matches_optax(grad_scale):
    from transplat_tpu.training.step import make_optimizer as jmake_optimizer

    rng = np.random.default_rng(2)
    shapes = {"a": (7, 5), "b": (11,), "c": (2, 3, 4)}
    params = {k: (1e-3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (grad_scale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    schedule = make_lr_schedule(2e-4, 1000)
    jopt = jmake_optimizer(optax.cosine_onecycle_schedule(1010, 2e-4, 0.01, 25.0, 1e4), 0.5)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    opt = make_optimizer(schedule, 0.5)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = opt.init(tparams)
    for i, g in enumerate(grads):
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        updates, jstate = jopt.update(jg, jstate, jparams)
        before = jparams
        jparams = optax.apply_updates(jparams, updates)
        told = {k: v.clone() for k, v in tparams.items()}
        norm = opt.update(tparams, {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)), rtol=1e-6)
        assert tstate.count == i + 1
        for k in shapes:
            # The update itself (about lr = 8e-6 per entry here): 1e-5 of its
            # largest entry, plus two float32 ulps of the parameters it is read
            # from (they are ~1e-3, so that the update is resolved).
            step_j = np.asarray(jparams[k]) - np.asarray(before[k])
            step_t = (tparams[k] - told[k]).numpy()
            ulps = 2.4e-7 * np.abs(np.asarray(jparams[k])).max()
            assert np.abs(step_t - step_j).max() <= 1e-5 * np.abs(step_j).max() + ulps, (i, k)
            assert np.abs(tparams[k].numpy() - np.asarray(jparams[k])).max() <= 1e-5 * np.abs(step_j).max() * (i + 1) + ulps
            adam = jstate[1][0]
            # Moments: 1e-6 of the leaf's largest entry (the port's lerp and
            # optax's b1 * mu + (1 - b1) * g round differently where they cancel).
            for got, ref in ((tstate.mu[k], adam.mu[k]), (tstate.nu[k], adam.nu[k])):
                ref = np.asarray(ref)
                assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max(), (i, k)


# ---------------------------------------------------------------------------
# (f) the whole step on the tiny config, dropout off, two steps
# ---------------------------------------------------------------------------

# Per quantity, after each of the two steps (measured: step 0 / step 1):
#   loss            1e-4 relative (1.2e-6 / 1.6e-6): the rendered image is a
#                   step function of the Gaussians, up to ~1.5% of colour
#                   values can differ end to end (tests/test_torch_encoder.py),
#                   and the loss averages them;
#   gradients       every leaf within 0.05 of its own L2 norm plus 5e-4 of the
#                   whole gradient's (4e-4 / 1.2e-2 of that sum; a bias in front
#                   of a normalisation has a gradient of pure rounding noise,
#                   which no relative bound holds); the whole gradient within
#                   0.01 of its norm (1e-4 / 2e-3); the global norm within 2e-3;
#   BatchNorm       running statistics within 1e-4 absolute + relative (they
#                   depend on the images, cameras and the CNN's weights only);
#   parameters      within 2.2 lr absolute per step taken (an Adam step moves
#                   an entry by at most ~1.05 lr) and the whole update
#                   (new - old), as one vector, with cosine similarity >= 0.99
#                   to JAX's (0.9999): Adam turns the first gradient into its
#                   sign, so a rounding-noise gradient entry can flip a whole
#                   lr, and the second step starts from those parameters.
STEP_TOL = dict(loss=1e-4, leaf=0.05, leaf_floor=5e-4, whole=0.01, norm=2e-3, stats=1e-4, cosine=0.99)
# compute_dtype="bfloat16": the depth predictor and the loss's LPIPS in
# bfloat16 in both packages (JAX compiled with each bfloat16 value rounded
# where the program rounds it, tests/test_torch_precision.py). The two round
# alike op for op, but the float32 stages before them differ by ~1e-6 and
# bfloat16 turns that into last-bit flips that spread (measured end to end
# there), so the step agrees to bfloat16's spread, not to float32's
# (measured, step 0 / step 1): loss 4.9e-4 / 3.9e-4,
# norm 1.7e-3 / 3.7e-4, worst leaf 0.17 / 0.17 (of its norm plus 1/60 of the
# whole's), whole gradient 1.6e-2 / 3.0e-2, update cosine
# 0.966 / 0.986 (Adam's first update is the gradient's sign, so it
# amplifies the flips most); BatchNorm statistics as in float32 (the CNN
# before the depth predictor is float32).
STEP_TOL_BF16 = dict(loss=2e-3, leaf=0.6, leaf_floor=1e-2, whole=0.08, norm=5e-3, stats=1e-4, cosine=0.93)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax_composition(compute_dtype):
    from transplat_tpu.loss.losses import LossCfg as JLossCfg
    from transplat_tpu.loss.losses import compute_losses as jcompute
    from transplat_tpu.loss.vgg import LPIPS as JLPIPS
    from transplat_tpu.model.decoder import DecoderCfg as JDC
    from transplat_tpu.model.decoder import decode_splatting as jdecode
    from transplat_tpu.model.encoder import EncoderTranSplat as JEnc
    from transplat_tpu.ops.rasterizer.api import RasterizeConfig as JRC
    from transplat_tpu.training.step import make_optimizer as jmake_optimizer

    jcfg, tcfg = (dataclasses.replace(c, compute_dtype=compute_dtype) for c in _tiny_cfgs())
    tol = STEP_TOL if compute_dtype == "float32" else STEP_TOL_BF16
    shape = (64, 64)
    batch = synthetic_batch(0, image_shape=shape, num_target=2)
    ctx = [batch["context"][k] for k in CONTEXT_KEYS]
    tgt = batch["target"]
    # LPIPS in the loss at the encoder's compute dtype, as the JAX make_train_step builds it
    jm, jl = JEnc(jcfg), JLPIPS(dtype=jnp.bfloat16 if compute_dtype == "bfloat16" else None)
    variables = random_variables(jm, *ctx, seed=11)
    variables["params"]["depth_predictor"]["to_disparity_2"]["kernel"][..., 0] *= 0.01  # see test_torch_encoder.py
    # (random_variables also draws the cross-attention offsets and weights,
    # which both packages initialise to zero, so their gradients are exercised.)
    zeros = np.zeros((1, *shape, 3), np.float32)
    lpips_params = random_variables(jl, zeros, zeros, seed=5)["params"]
    lr, max_steps = 2e-4, 1000

    # JAX: the package's own parts, dropout off, BatchNorm on batch statistics.
    # mode="reference": JAX's tiled mode multiplies T_final past saturation.
    jopt = jmake_optimizer(optax.cosine_onecycle_schedule(max_steps + 10, lr, 0.01, 25.0, 1e4), 0.5)
    jctx = [jnp.asarray(a) for a in ctx]
    jcams = [jnp.asarray(tgt[k]) for k in ("extrinsics", "intrinsics", "near", "far")]

    def jloss(params, batch_stats, step, lpips_params, target):
        gaussians, updates = jm.apply(
            {"params": params, "batch_stats": batch_stats}, *jctx, global_step=step, train=True,
            deterministic=True, mutable=["batch_stats"],
        )
        out = jdecode(gaussians, *jcams, shape, cfg=JDC(rasterize=JRC(mode="reference")))
        total, _ = jcompute(
            JLossCfg(), out.color, target, step, lpips_fn=lambda a, b: jl.apply({"params": lpips_params}, a, b),
        )
        return total, updates["batch_stats"]

    # LPIPS's weights and the target images are arguments: as constants XLA
    # would evaluate the target's VGG features while compiling, for minutes.
    def jstep_fn(params, batch_stats, opt_state, step, lpips_params, target):
        (loss, new_stats), grads = jax.value_and_grad(jloss, has_aux=True)(params, batch_stats, step, lpips_params, target)
        updates, opt_state = jopt.update(grads, opt_state, params)
        return loss, grads, new_stats, optax.apply_updates(params, updates), opt_state

    jparams = jax.tree.map(jnp.asarray, variables["params"])
    jstats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    jopt_state = jopt.init(jparams)
    # Each bfloat16 value rounded where the program rounds it (no effect in float32).
    fixed = (jax.tree.map(jnp.asarray, lpips_params), jnp.asarray(tgt["image"]))
    jstep = jax.jit(jstep_fn).lower(jparams, jstats, jopt_state, jnp.asarray(0), *fixed).compile(
        compiler_options={"xla_allow_excess_precision": False})

    # The port: make_train_step with dropout off.
    lpips = LPIPS(device="cpu")
    load_jax_variables(lpips, {"params": lpips_params})
    opt = make_optimizer(make_lr_schedule(lr, max_steps), 0.5)
    state = create_train_state(tcfg, opt, lpips, device="cpu")
    encoder = state.encoder
    load_jax_variables(encoder, variables)
    step_fn = make_train_step(tcfg, LossCfg(), re10k_decoder_cfg(), opt, shape, deterministic=True)
    tbatch = {
        side: {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in batch[side].items() if k != "index"}
        for side in ("context", "target")
    }

    for i in range(2):
        loss_j, grads_j, jstats, new_jparams, jopt_state = jstep(jparams, jstats, jopt_state, jnp.asarray(i), *fixed)
        # The gradients of this step, on a copy: a forward in training mode moves the BatchNorm statistics.
        _, grads_t = loss_and_grads(copy.deepcopy(state), tbatch, LossCfg(), re10k_decoder_cfg(), shape, deterministic=True)
        before = to_jax_tree(encoder)
        state, metrics = step_fn(state, tbatch)
        after = to_jax_tree(encoder)
        assert state.step == i + 1 and not encoder.training

        np.testing.assert_allclose(float(metrics["loss"]), float(loss_j), rtol=tol["loss"], err_msg=f"step {i}")
        np.testing.assert_allclose(
            float(metrics["grad_norm"]), float(optax.global_norm(grads_j)), rtol=tol["norm"], err_msg=f"step {i}"
        )
        assert float(metrics["lr"]) == pytest.approx(make_lr_schedule(lr, max_steps)(i))
        assert float(metrics["render_overflow"]) == 0.0

        gj, gt = flat(grads_j), flat(to_jax_tree(encoder, grads_t)["params"])
        trainable = {k for k in gj if k[0] != "da_model"}
        assert set(gt) == trainable  # leaf for leaf; the frozen DAv2 has no gradient in the port
        assert all(float(np.abs(gj[k]).max()) == 0.0 for k in gj if k[0] == "da_model")  # and a zero one in JAX
        whole = np.sqrt(sum(float(np.sum(gj[k].astype(np.float64) ** 2)) for k in trainable))
        diff2, worst_leaf = 0.0, 0.0
        for k in sorted(trainable):
            assert gt[k].shape == gj[k].shape, k
            d = float(np.linalg.norm((gt[k] - gj[k]).astype(np.float64)))
            diff2 += d * d
            norm = float(np.linalg.norm(gj[k]))
            worst_leaf = max(worst_leaf, d / (norm + tol["leaf_floor"] / tol["leaf"] * whole))
            assert d <= tol["leaf"] * norm + tol["leaf_floor"] * whole, (i, "/".join(k), d, norm, whole)
        assert np.sqrt(diff2) <= tol["whole"] * whole, (i, np.sqrt(diff2) / whole)

        sj, st = flat(jstats), flat(after["batch_stats"])
        assert set(sj) == set(st) and len(sj) == 8
        for k in sj:
            np.testing.assert_allclose(st[k], sj[k], rtol=tol["stats"], atol=tol["stats"], err_msg="/".join(k))
        assert any(not np.array_equal(st[k], flat(before["batch_stats"])[k]) for k in st)  # they moved

        pj_old, pj_new = flat(jparams), flat(new_jparams)
        pt_old, pt_new = flat(before["params"]), flat(after["params"])
        lr_now = make_lr_schedule(lr, max_steps)(i)
        dot = nj = nt = 0.0
        for k in sorted(trainable):
            assert np.abs(pt_new[k] - pj_new[k]).max() <= 2.2 * lr_now * (i + 1), (i, "/".join(k))
            uj = (pj_new[k] - pj_old[k]).astype(np.float64).ravel()
            ut = (pt_new[k] - pt_old[k]).astype(np.float64).ravel()
            dot, nj, nt = dot + float(uj @ ut), nj + float(uj @ uj), nt + float(ut @ ut)
        assert dot / np.sqrt(nj * nt) >= tol["cosine"], (i, dot / np.sqrt(nj * nt))
        print(  # shown with pytest -s: what the bounds above leave room for
            f"step {i}: loss rel {abs(float(metrics['loss']) / float(loss_j) - 1):.2e}, "
            f"norm rel {abs(float(metrics['grad_norm']) / float(optax.global_norm(grads_j)) - 1):.2e}, worst leaf {worst_leaf:.2e}, "
            f"whole gradient {np.sqrt(diff2) / whole:.2e}, update cosine {dot / np.sqrt(nj * nt):.4f}"
        )
        for k in gj:
            if k[0] == "da_model":  # frozen in both
                np.testing.assert_array_equal(pt_new[k], pt_old[k])
                np.testing.assert_array_equal(pj_new[k], pj_old[k])
        jparams = new_jparams


# ---------------------------------------------------------------------------
# (g) dropout and train / eval behaviour of the port
# ---------------------------------------------------------------------------


def test_dropout_masks_scaling_and_generator():
    from transplat_tpu_torch.model.layers import Dropout

    drop = Dropout(0.1)
    x = torch.ones(200, 500)
    assert drop.eval()(x, None) is x  # identity in eval mode, no generator needed
    drop.train()
    with pytest.raises(ValueError, match="Generator"):
        drop(x, None)
    a = drop(x, torch.Generator().manual_seed(3))
    b = drop(x, torch.Generator().manual_seed(3))
    c = drop(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)  # masks come from the generator alone
    torch.manual_seed(0)
    state = torch.get_rng_state()
    drop(x, torch.Generator().manual_seed(5))
    assert torch.equal(torch.get_rng_state(), state)  # the global RNG is not touched
    kept = float((a != 0).float().mean())
    assert abs(kept - 0.9) < 0.005  # 1e5 draws: sigma 1e-3
    assert torch.all((a == 0) | torch.isclose(a, torch.tensor(1.0 / 0.9)))
    assert Dropout(0.0).train()(x, None) is x


@pytest.fixture(scope="module")
def tiny_encoder():
    from transplat_tpu_torch.inference import init_random
    from transplat_tpu_torch.model.encoder import EncoderTranSplat as TEnc

    _, tcfg = _tiny_cfgs()
    encoder = TEnc(tcfg, device="cpu")
    init_random(encoder, 1)
    batch = synthetic_batch(1, image_shape=(64, 64), num_target=2)
    ctx = [torch.from_numpy(batch["context"][k]) for k in CONTEXT_KEYS]
    return encoder, ctx


def test_encoder_train_and_eval_modes(tiny_encoder):
    from transplat_tpu_torch.model.layers import Dropout

    encoder, ctx = tiny_encoder
    assert not encoder.training  # starts in eval mode
    assert not any(p.requires_grad for p in encoder.da_model.parameters())  # DAv2 is frozen
    stats = {k: v.clone() for k, v in encoder.state_dict().items() if "running" in k}
    with torch.no_grad():
        base = encoder(*ctx)
        assert all(torch.equal(a, b) for a, b in zip(base, encoder(*ctx, generator=torch.Generator().manual_seed(0))))
    assert all(torch.equal(v, encoder.state_dict()[k]) for k, v in stats.items())  # eval leaves the statistics alone

    dropouts = [m for m in encoder.modules() if isinstance(m, Dropout)]
    assert len(dropouts) == 6 and all(m.rate == 0.1 for m in dropouts)  # 2 fine layers x (self, cross, FFN)
    encoder.train()
    try:
        with pytest.raises(ValueError, match="Generator"):
            encoder(*ctx)
        with torch.no_grad():
            a = encoder(*ctx, generator=torch.Generator().manual_seed(7))
            moved = {k: v.clone() for k, v in encoder.state_dict().items() if "running" in k}
            b = encoder(*ctx, generator=torch.Generator().manual_seed(7))
            c = encoder(*ctx, generator=torch.Generator().manual_seed(8))
        assert all(torch.equal(x, y) for x, y in zip(a, b))  # reproducible from the generator
        assert not torch.equal(a.means, c.means)  # and different with another seed
        assert any(not torch.equal(v, stats[k]) for k, v in moved.items())  # BatchNorm statistics move

        # Rate 0 in training mode: dropout is the identity, BatchNorm is on batch statistics.
        for m in dropouts:
            m.train(False)
        with torch.no_grad():
            d = encoder(*ctx)
        assert not torch.equal(d.means, a.means)
    finally:
        encoder.eval()
        encoder.load_state_dict({**encoder.state_dict(), **stats})


def test_batchnorm_follows_flax_in_training():
    """Batch statistics, biased variance into the running one, momentum 0.1."""
    import flax.linen as fnn

    from transplat_tpu_torch.model.layers import BatchNorm1d, BatchNorm2d

    rng = np.random.default_rng(4)
    for port, shape, to_jax in (
        (BatchNorm1d(16, eps=1e-5, momentum=0.1), (3, 16), lambda a: a),
        (BatchNorm2d(16, eps=1e-5, momentum=0.1), (2, 16, 5, 7), lambda a: a.transpose(0, 2, 3, 1)),
    ):
        x = rng.standard_normal(shape).astype(np.float32) * 2.0 + 0.5
        jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
        variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(to_jax(x)))
        ref, updates = jbn.apply(variables, jnp.asarray(to_jax(x)), mutable=["batch_stats"])
        port.train()
        out = port(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(to_jax(out), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(updates["batch_stats"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(port.running_var.numpy(), np.asarray(updates["batch_stats"]["var"]), atol=1e-6)
        jeval = fnn.BatchNorm(use_running_average=True, momentum=0.9)
        port.eval()
        ref_eval = jeval.apply({"params": variables["params"], "batch_stats": updates["batch_stats"]}, jnp.asarray(to_jax(x)))
        np.testing.assert_allclose(to_jax(port(torch.from_numpy(x)).detach().numpy()), np.asarray(ref_eval), atol=1e-5)


def test_global_step_reaches_the_opacity_map(tiny_encoder):
    import dataclasses

    from transplat_tpu.model.encoder import OpacityMappingCfg as JOM
    from transplat_tpu.model.encoder import map_pdf_to_opacity as jmap
    from transplat_tpu_torch.model.encoder import OpacityMappingCfg, map_pdf_to_opacity

    pdf = np.random.default_rng(0).random(64).astype(np.float32)
    for step in (0, 50, 100, 500):
        got = map_pdf_to_opacity(torch.from_numpy(pdf), OpacityMappingCfg(0.0, 2.0, 100), step)
        ref = jmap(jnp.asarray(pdf), JOM(0.0, 2.0, 100), jnp.asarray(step))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    encoder, ctx = tiny_encoder
    old = encoder.cfg
    encoder.cfg = dataclasses.replace(old, opacity_mapping=OpacityMappingCfg(0.0, 2.0, 100))
    try:
        with torch.no_grad():
            early, late = encoder(*ctx, global_step=0), encoder(*ctx, global_step=100)
        assert torch.equal(early.means, late.means) and not torch.equal(early.opacities, late.opacities)
    finally:
        encoder.cfg = old


def test_train_demo_runs_on_the_cpu(capsys):
    import json

    from transplat_tpu_torch import train_demo

    assert train_demo.main(["--device", "cpu", "--tiny", "--steps", "2"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["step"] for r in lines[:2]] == [1, 2] and lines[-1]["device"] == "cpu"
    for r in lines[:2]:
        assert {"loss", "mse", "lpips", "psnr", "grad_norm", "lr", "render_overflow"} <= set(r)
        assert all(np.isfinite(v) for v in r.values()) and r["grad_norm"] > 0 and r["render_overflow"] == 0
