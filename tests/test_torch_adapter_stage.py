"""The encoder's Gaussian adapter stage (model/encoder.py `adapt_stage`) on the
CPU: its plain version against the JAX package's stage 5, which path a call
takes and how the program counts it, and the kernel wrapper's checks, which
refuse bad input before any launch. The kernel itself
(csrc/gaussian_adapter.cu) runs only on a card: tests/test_torch_cuda.py
holds it against the plain stage there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import ADAPTER_TOL, adapter_case, adapter_errors
from transplat_tpu_torch import kernels
from transplat_tpu_torch.model.adapter import adapt_gaussians_fused
from transplat_tpu_torch.model.encoder import EncoderTranSplat, adapt_stage, opacity_exponent
from transplat_tpu_torch.utils import trace

CPU = torch.device("cpu")
CONTEXT = ("image", "intrinsics", "extrinsics", "near", "far")


def jax_stage(cfg, extr, intr, raw, depth, density, step, shape) -> dict:
    """Stage 5 as the JAX encoder writes it (transplat_tpu/model/encoder.py),
    from the JAX package's functions."""
    from transplat_tpu.geometry.projection import sample_image_grid
    from transplat_tpu.model import adapter as ja
    from transplat_tpu.model.encoder import OpacityMappingCfg, map_pdf_to_opacity

    (h, w), (b, v, r) = shape, depth.shape[:3]
    depth, density = depth[..., 0], density[..., 0]  # one Gaussian a pixel
    a = cfg.gaussian_adapter
    jcfg = ja.GaussianAdapterCfg(a.gaussian_scale_min, a.gaussian_scale_max, a.sh_degree)
    om = cfg.opacity_mapping
    extr, intr, raw, depth, density = (jnp.asarray(t.numpy()) for t in (extr, intr, raw, depth, density))
    xy, _ = sample_image_grid((h, w))
    pixel_size = jnp.asarray([1.0 / w, 1.0 / h], raw.dtype)
    coords = xy.reshape(1, 1, r, 2) + (jax.nn.sigmoid(raw[..., :2]) - 0.5) * pixel_size
    opacities = map_pdf_to_opacity(density, OpacityMappingCfg(om.initial, om.final, om.warm_up), jnp.asarray(step))
    out = ja.adapt_gaussians(jcfg, extr, intr, coords, depth, opacities / cfg.gaussians_per_pixel, raw[..., 2:], (h, w))
    return {
        "means": out["means"].reshape(b, v * r, 3),
        "covariances": out["covariances"].reshape(b, v * r, 3, 3),
        "harmonics": out["harmonics"].reshape(b, v * r, 3, a.d_sh),
        "opacities": out["opacities"].reshape(b, v * r),
        "scales": out["scales"],
        "rotations": out["rotations"],
    }


@pytest.mark.parametrize("step", [3, 50])
@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_plain_stage_matches_the_jax_stage(degree, step):
    """On the CPU the stage takes its plain version, which equals the JAX
    package's stage 5: SH degrees 0-4, cameras turned by the identity, near
    180 degrees and at random, off-centre intrinsics, inside and after the
    opacity warm-up."""
    cfg, args = adapter_case(CPU, 1, 3, (6, 7), degree, step, seed=degree)
    trace.reset_counters()
    got = adapt_stage(cfg, *args, with_aux=True)
    assert trace.counters() == {"adapter.plain": 1}
    ref = {k: torch.from_numpy(np.array(t)) for k, t in jax_stage(cfg, *args).items()}
    errs = adapter_errors(got, ref)
    assert max(errs.values()) <= ADAPTER_TOL, errs


def test_the_encoder_counts_one_plain_stage_a_forward_on_the_cpu():
    from transplat_tpu_torch.dataset import synthetic_batch
    from transplat_tpu_torch.inference import init_random
    from transplat_tpu_torch.train_demo import tiny_encoder_cfg

    encoder = EncoderTranSplat(tiny_encoder_cfg(), device="cpu")
    init_random(encoder, 0)
    batch = synthetic_batch(0, batch_size=1, num_context=2, num_target=1, image_shape=(64, 64))
    ctx = [torch.as_tensor(batch["context"][k]) for k in CONTEXT]
    trace.reset_counters()
    kernels.reset_launches()
    with torch.no_grad():
        first = encoder(*ctx)
    second = encoder(*ctx)  # parameters requiring grad, grad mode on
    # Both forwards run eagerly on the CPU (no CUDA graph): encoder.graph.eager.
    assert trace.counters() == {"adapter.plain": 2, "encoder.graph.eager": 2} and kernels.launches == {}
    assert second.means.requires_grad and not first.means.requires_grad
    assert all(torch.equal(a, b.detach()) for a, b in zip(first, second))


def test_an_input_requiring_grad_takes_the_plain_path():
    cfg, (extr, intr, raw, depth, density, step, shape) = adapter_case(CPU, 1, 2, (4, 5), 2, 3, seed=1)
    raw = raw.clone().requires_grad_()
    trace.reset_counters()
    out = adapt_stage(cfg, extr, intr, raw, depth, density, step, shape)
    assert trace.counters() == {"adapter.plain": 1}
    grads = torch.autograd.grad(out["harmonics"].sum() + out["covariances"].sum(), raw)
    assert grads[0].abs().sum() > 0
    assert not kernels.kernel_route(raw, depth)  # CPU tensors never take the kernel
    with torch.no_grad():
        assert not kernels.kernel_route(raw.detach(), depth)


def test_opacity_exponent_is_the_curve_of_map_pdf_to_opacity():
    from transplat_tpu_torch.model.encoder import OpacityMappingCfg, map_pdf_to_opacity

    om = OpacityMappingCfg(-1.0, 1.0, 10)
    pdf = torch.linspace(0.0, 1.0, 11)
    for step, exponent in ((0, 0.5), (5, 1.0), (10, 2.0), (50, 2.0)):
        assert opacity_exponent(om, step) == exponent
        want = 0.5 * (1.0 - (1.0 - pdf) ** exponent + pdf ** (1.0 / exponent))
        assert torch.equal(map_pdf_to_opacity(pdf, om, step), want)


def _bad(name: str, args: tuple):
    """The wrapper's arguments with one of them broken as `name` says."""
    extr, intr, raw, depth, density = args
    if name == "extrinsics":
        extr = extr[..., :3, :]
    elif name == "intrinsics":
        intr = intr[:, :1]
    elif name == "raw":
        raw = raw[..., :-1]
    elif name == "depths":
        depth = depth[:, :, :-1]
    elif name == "densities":
        density = density[:, :, None]
    return extr, intr, raw, depth, density


@pytest.mark.parametrize("name", ["extrinsics", "intrinsics", "raw", "depths", "densities", "sh_degree", "device"])
def test_the_kernel_wrapper_refuses_bad_input_before_any_launch(name):
    from transplat_tpu_torch.model.adapter import GaussianAdapterCfg

    cfg, (extr, intr, raw, depth, density, step, shape) = adapter_case(CPU, 1, 2, (4, 5), 4, 3, seed=2)
    adapter = cfg.gaussian_adapter
    args = _bad(name, (extr, intr, raw, depth, density))
    if name == "sh_degree":
        adapter = GaussianAdapterCfg(sh_degree=5)
        raw = torch.zeros(*raw.shape[:-1], 2 + adapter.d_in)
        args = (extr, intr, raw, depth, density)
    kernels.reset_launches()
    match = {"sh_degree": "SH degree", "device": "CUDA"}.get(name, f"{name} has shape")
    with pytest.raises(ValueError, match=match):
        adapt_gaussians_fused(adapter, *args, opacity_exponent(cfg.opacity_mapping, step), 1, shape)
    assert kernels.launches == {}
