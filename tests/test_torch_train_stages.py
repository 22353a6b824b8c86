"""The sub-graphs that the port's `bench_train_stages` times (the encoder,
the render, LPIPS; forward and forward + backward), against the sub-graphs
that scripts/bench_train_stages.py builds, on the CPU at the tiny
configuration, each JAX sub-graph compiled once for its outputs and its
gradient; fixtures, helpers and tolerances of tests/test_torch_stage_benches.py
(the render's gradient bound RENDER_GRAD_TOL is explained there).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_modules import random_variables
from test_torch_stage_benches import (  # noqa: F401  (weights and one_torch_thread are fixtures)
    INPUT_GRAD_TOL,
    RENDER_GRAD_TOL,
    SHAPE,
    assert_grads_close,
    assert_outputs_close,
    lazy,
    one_torch_thread,
    outputs_and_grad,
    scaled,
    weights,
)
from test_torch_training import flat
from transplat_tpu_torch import bench_train_stages
from transplat_tpu_torch.convert import load_jax_variables, to_jax_tree


@pytest.fixture(scope="module")
def train_rows(weights):
    from transplat_tpu.loss.vgg import LPIPS as JLPIPS
    from transplat_tpu.model.decoder import DecoderCfg as JDC
    from transplat_tpu.model.decoder import decode_splatting as jdecode
    from transplat_tpu.model.encoder import EncoderTranSplat as JEnc
    from transplat_tpu.model.types import Gaussians as JGaussians
    from transplat_tpu.ops.rasterizer.api import RasterizeConfig as JRC
    from transplat_tpu_torch.loss import LPIPS

    jl = JLPIPS()
    zeros = np.zeros((1, *SHAPE, 3), np.float32)
    lpips_params = random_variables(jl, zeros, zeros, seed=5)["params"]
    lpips = LPIPS(device="cpu")
    load_jax_variables(lpips, {"params": lpips_params})
    port_rows = bench_train_stages.subgraphs(weights["port"], lpips, weights["batch"], "cpu")

    jm, variables, tgt = JEnc(weights["jcfg"]), weights["variables"], weights["batch"]["target"]
    cams = [jnp.asarray(tgt[k]) for k in ("extrinsics", "intrinsics", "near", "far")]
    target = jnp.asarray(tgt["image"])

    def enc_fwd(params):
        return jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, *weights["ctx"])

    def render_from(gaussians):  # mode="reference": JAX's tiled mode multiplies T_final past saturation
        return jdecode(gaussians, *cams, SHAPE, cfg=JDC(rasterize=JRC(mode="reference"))).color

    def lpips_loss(pred):
        return jnp.sum(jl.apply({"params": lpips_params}, pred.reshape(-1, *SHAPE, 3), target.reshape(-1, *SHAPE, 3)))

    def compute():
        gaussians, enc_grad = outputs_and_grad(enc_fwd)(variables["params"])
        # The render and LPIPS rows take the port's Gaussians and colours: the
        # rendered image is a step function of the Gaussians (tests/test_torch_encoder.py).
        port_g = JGaussians(*(jnp.asarray(t.detach().numpy()) for t in port_rows["encoder fwd"]()))
        color, render_grad = outputs_and_grad(render_from, lambda c: jnp.sum((c - target) ** 2))(port_g)
        port_color = jnp.asarray(port_rows["render fwd"]().numpy())
        lp, lpips_grad = outputs_and_grad(lpips_loss, lambda s: s)(port_color)
        return {
            "encoder fwd": gaussians, "encoder fwd+bwd": enc_grad, "render fwd": color,
            "render fwd+bwd": render_grad, "lpips fwd": lp, "lpips fwd+bwd": lpips_grad,
        }

    row = lazy(compute)
    return port_rows, {name: row(name) for name in bench_train_stages.ROWS}


@pytest.mark.parametrize("row", bench_train_stages.ROWS)
def test_train_stage_subgraph_matches_jax(row, weights, train_rows):
    port_rows, jax_rows = train_rows
    got, ref = port_rows[row](), jax_rows[row]()
    if row == "encoder fwd+bwd":
        grads = flat(ref)
        assert all(float(np.abs(grads[k]).max()) == 0.0 for k in grads if k[0] == "da_model")  # frozen: no gradient
        assert_grads_close(flat(to_jax_tree(weights["port"], got)["params"]),
                           {k: g for k, g in grads.items() if k[0] != "da_model"}, row)
    elif row == "render fwd+bwd":
        for name, ref_g in ref._asdict().items():
            err = scaled(got[name].numpy(), ref_g)
            print(row, name, "error scaled to the largest entry:", err)
            assert err <= RENDER_GRAD_TOL, (name, err)
    elif row == "lpips fwd+bwd":
        err = scaled(got["pred"].numpy(), ref)
        print(row, "error scaled to the largest entry:", err)
        assert err <= INPUT_GRAD_TOL, err
    else:
        assert_outputs_close(list(got) if row == "encoder fwd" else [got], list(ref) if row == "encoder fwd" else [ref],
                             row)
