"""The golden-scene overfit curve of the port against the JAX package's, on
the CPU, from the same parameters.

The reduced golden gate (test_torch_fit_eval.py::test_golden_overfit_cpu,
tests/test_training.py::TestGoldenOverfit) runs each package from its own
initial draw, and the JAX one at a tile capacity that drops thousands of
pairs a step; its curve and the port's cannot be compared. Here both start
from the same parameters (the Flax initialisers as model/init.py draws
them, as a JAX tree by convert.to_jax_tree and back into the port's encoder
by convert.load_jax_variables), with dropout off, on the reduced scene
(tiny encoder, 32x32 golden planes, MSE only, clip 0.5 + Adam at lr 2e-3
after one warm-up step), and the JAX renderer runs at a capacity that drops
nothing (RasterizeConfig(capacity=4096, max_tiles_per_gaussian=64); its
overflow is asserted 0 at every step). The PSNR of every 10th step is held
to the JAX package's within EARLY_BOUND_DB up to step EARLY_STEPS and
LATE_BOUND_DB after it.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fit_eval import SHAPE, TINY_ENCODER, golden, tiny_cfg
from transplat_tpu.loss.losses import LossCfg as JLossCfg
from transplat_tpu.loss.losses import compute_losses as jcompute
from transplat_tpu.model.adapter import GaussianAdapterCfg as JAdapterCfg
from transplat_tpu.model.decoder import DecoderCfg as JDecoderCfg
from transplat_tpu.model.decoder import decode_splatting as jdecode
from transplat_tpu.model.encoder import EncoderCfg as JEncoderCfg
from transplat_tpu.model.encoder import EncoderTranSplat as JEncoder
from transplat_tpu.ops.rasterizer.api import RasterizeConfig as JRasterizeConfig
from transplat_tpu.training.schedule import make_lr_schedule as jmake_lr_schedule
from transplat_tpu.training.step import make_optimizer as jmake_optimizer
from transplat_tpu_torch.convert import load_jax_variables, to_jax_tree
from transplat_tpu_torch.dataset import loader as port_loader
from transplat_tpu_torch.loss import LossCfg
from transplat_tpu_torch.training import create_train_state, make_lr_schedule, make_optimizer, make_train_step

# Compiling the JAX step alone takes ~50 s on a CPU, so the test runs past a
# minute whatever the number of steps: it is marked slow and takes the
# reduced gate's whole length.
pytestmark = pytest.mark.slow

STEPS = 100
EVERY = 10
# Where the curves may part, and why. Both packages render the same
# Gaussians to within 1e-5, but the image is a step function of them (the
# integer cutoff radius ceil(3 sqrt(lambda_max)) and the 1/255 alpha floor,
# ROADMAP.md queue 3), so a Gaussian that crosses a threshold in one package
# and not the other flips a few pixels; float32 sums in other orders do the
# rest, and Adam carries each difference on. Measured on the CPU from these
# parameters: 10.48 -> 22.86 dB (JAX) and 10.48 -> 22.60 dB (port); the
# curves stay within 0.005 dB of each other up to step 40, then the fit
# passes steps where such flips move either curve, and they part by up to
# 0.85 dB (step 90). A fault in a gradient or the optimizer moves a curve by
# dB from the first steps on (the reduced gate's start differs by 2.5 dB
# between the two packages' own initial draws).
EARLY_STEPS = 40
EARLY_BOUND_DB = 0.25
LATE_BOUND_DB = 1.5


def _jax_curve(variables, batch, steps):
    """PSNR (dB) and overflow of every step of the JAX package's own parts,
    dropout off, BatchNorm on batch statistics."""
    kw = {k: v for k, v in TINY_ENCODER.items() if k != "gaussian_adapter"}
    model = JEncoder(JEncoderCfg(**kw, gaussian_adapter=JAdapterCfg(sh_degree=1)))
    decoder_cfg = JDecoderCfg(rasterize=JRasterizeConfig(capacity=4096, max_tiles_per_gaussian=64))
    optimizer = jmake_optimizer(jmake_lr_schedule(2e-3, 200, cosine=False, warm_up_steps=1), grad_clip=0.5)
    ctx = [jnp.asarray(batch["context"][k]) for k in ("image", "intrinsics", "extrinsics", "near", "far")]
    cams = [jnp.asarray(batch["target"][k]) for k in ("extrinsics", "intrinsics", "near", "far")]
    target = jnp.asarray(batch["target"]["image"])

    def loss_fn(params, batch_stats, step):
        gaussians, updates = model.apply(
            {"params": params, "batch_stats": batch_stats}, *ctx, global_step=step, train=True,
            deterministic=True, mutable=["batch_stats"],
        )
        out = jdecode(gaussians, *cams, SHAPE, cfg=decoder_cfg)
        total, _ = jcompute(JLossCfg(lpips_weight=0.0), out.color, target, step)
        mse = jnp.mean((jnp.clip(out.color, 0, 1) - jnp.clip(target, 0, 1)) ** 2)
        return total, (updates["batch_stats"], -10.0 * jnp.log10(mse + 1e-12), jnp.sum(out.overflow))

    @jax.jit
    def step_fn(params, batch_stats, opt_state, step):
        (_, (batch_stats, psnr, overflow)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch_stats, step)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return jax.tree.map(jnp.add, params, updates), batch_stats, opt_state, psnr, overflow

    params, batch_stats = variables["params"], variables["batch_stats"]
    opt_state = optimizer.init(params)
    curve, overflow = [], []
    for i in range(steps):
        params, batch_stats, opt_state, psnr, over = step_fn(params, batch_stats, opt_state, jnp.asarray(i))
        curve.append(float(psnr))
        overflow.append(int(over))
    return curve, overflow


def _port_curve(variables, steps):
    opt = make_optimizer(make_lr_schedule(2e-3, 200, cosine=False, warm_up_steps=1), grad_clip=0.5)
    state = create_train_state(_cfg().encoder, opt, None, device="cpu")
    load_jax_variables(state.encoder, variables)
    step = make_train_step(_cfg().encoder, LossCfg(lpips_weight=0.0), _cfg().decoder, opt, SHAPE, deterministic=True)
    batch = port_loader.batch_to_device(golden(), "cpu")
    curve = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        curve.append(float(metrics["psnr"]))
    return curve


def _cfg():
    return tiny_cfg(Path("unused"))  # nothing is saved


def test_golden_curve_follows_jax_from_the_same_parameters():
    torch.set_num_threads(2)
    batch = golden()
    initial = create_train_state(_cfg().encoder, make_optimizer(lambda step: 0.0), None, device="cpu", seed=0)
    variables = jax.tree.map(np.asarray, to_jax_tree(initial.encoder))

    jax_psnr, overflow = _jax_curve(variables, batch, STEPS)
    port_psnr = _port_curve(variables, STEPS)
    assert overflow == [0] * STEPS, overflow
    assert np.isfinite(jax_psnr).all() and np.isfinite(port_psnr).all()
    checked = list(range(0, STEPS, EVERY)) + [STEPS - 1]
    gaps = {i: abs(port_psnr[i] - jax_psnr[i]) for i in checked}
    curves = ([round(jax_psnr[i], 3) for i in checked], [round(port_psnr[i], 3) for i in checked])
    for i, gap in gaps.items():
        assert gap <= (EARLY_BOUND_DB if i <= EARLY_STEPS else LATE_BOUND_DB), (i, gaps, curves)
    # Both fit the scene: the curve rises, as the golden gate asks.
    assert jax_psnr[-1] - jax_psnr[0] > 1.0 and port_psnr[-1] - port_psnr[0] > 1.0
