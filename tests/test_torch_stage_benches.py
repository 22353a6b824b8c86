"""The sub-graphs that the port's `bench_encoder_stages` times, against the
sub-graphs that scripts/bench_encoder_stages.py builds, on the CPU
at the tiny configuration of __graft_entry__.py (2 context and 2 target
views at 64x64): from one set of JAX variables (`load_jax_variables`) on the
same seeded inputs, each forward's outputs and each forward + backward's
gradient of the scripts' scalarised loss. The JAX side runs its plain
routes (the renderer in mode="reference", as tests/test_torch_grads.py);
each JAX sub-graph compiles once, for its outputs and its gradient together.
The fixtures, helpers and tolerances here serve tests/test_torch_train_stages.py
(`bench_train_stages`) and tests/test_torch_stage_tools.py (`bench_dp_stages`
and the other tools) too.

Tolerances: outputs within OUT_TOL (the tiny encoder's 1e-3 of
tests/test_torch_encoder.py); parameter gradients as the training step's
float32 comparison (tests/test_torch_training.py STEP_TOL: the whole
gradient within GRAD_WHOLE of its norm, each leaf within GRAD_LEAF of its
own norm plus GRAD_FLOOR of the whole); LPIPS's input gradient within
INPUT_GRAD_TOL of its largest entry (tests/test_torch_grads.py's renderer
bound). The render's gradient on the encoder's Gaussians within
RENDER_GRAD_TOL of its largest entry: its forward is a step function of
thin splats' projections (ROADMAP section 3; the same Gaussians render
within 1.9e-4 here), and the gradient moves with it (readings: means
6.9e-4, covariances 2.6e-4, harmonics 1.5e-4, opacities 8.1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_encoder import _tiny_cfgs
from test_torch_modules import random_variables
from test_torch_training import flat
from transplat_tpu_torch import bench_encoder_stages
from transplat_tpu_torch.convert import load_jax_variables, to_jax_tree
from transplat_tpu_torch.dataset import synthetic_batch

SHAPE = (64, 64)
CONTEXT_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")
OUT_TOL = 1e-3
GRAD_WHOLE, GRAD_LEAF, GRAD_FLOOR = 1e-2, 5e-2, 5e-4
INPUT_GRAD_TOL = 5e-5
RENDER_GRAD_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as tests/test_torch_cli.py: tiny models run many
    small ops, whose threads oversubscribe the cores under several workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def scaled(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def jscalarize(tree):
    """The JAX scripts' scalar head."""
    return sum(jnp.sum(x.astype(jnp.float32) ** 2) * 1e-6 for x in jax.tree.leaves(tree))


def outputs_and_grad(fn, loss=jscalarize):
    """(fn(x, *rest), d loss(fn) / d x), jitted once."""
    def scalar(x, *rest):
        out = fn(x, *rest)
        return loss(out), out

    def run(x, *rest):
        (_, out), grad = jax.jit(jax.value_and_grad(scalar, has_aux=True))(x, *rest)
        return out, grad

    return run


def lazy(compute):
    """{row: () -> value} from `compute` () -> {row: value}, computed on the first call."""
    once = functools.cache(compute)
    return lambda row: (lambda: once()[row])


@pytest.fixture(scope="module")
def weights():
    """JAX variables of the tiny encoder, the batch, and the port's encoder loaded with them."""
    from transplat_tpu.model.encoder import EncoderTranSplat as JEnc
    from transplat_tpu_torch.model.encoder import EncoderTranSplat

    jcfg, tcfg = _tiny_cfgs()
    batch = synthetic_batch(0, image_shape=SHAPE, num_target=2)
    ctx = [batch["context"][k] for k in CONTEXT_KEYS]
    variables = random_variables(JEnc(jcfg), *ctx, seed=11)
    variables["params"]["depth_predictor"]["to_disparity_2"]["kernel"][..., 0] *= 0.01  # see test_torch_encoder.py
    port = EncoderTranSplat(tcfg, device="cpu")
    load_jax_variables(port, variables)
    return {"jcfg": jcfg, "variables": variables, "batch": batch, "ctx": [jnp.asarray(a) for a in ctx], "port": port}


def jax_depth_predictor(cfg):
    from transplat_tpu.model.depth_predictor import DepthPredictor

    return DepthPredictor(
        feature_channels=cfg.d_feature, upscale_factor=cfg.downscale_factor,
        num_depth_candidates=cfg.num_depth_candidates, costvolume_unet_feat_dim=cfg.costvolume_unet_feat_dim,
        costvolume_unet_channel_mult=cfg.costvolume_unet_channel_mult,
        costvolume_unet_attn_res=cfg.costvolume_unet_attn_res,
        gaussian_raw_channels=cfg.num_surfaces * (cfg.gaussian_adapter.d_in + 2),
        gaussians_per_pixel=cfg.gaussians_per_pixel, num_views=cfg.num_context_views,
        depth_unet_feat_dim=cfg.depth_unet_feat_dim, depth_unet_attn_res=cfg.depth_unet_attn_res,
        depth_unet_channel_mult=cfg.depth_unet_channel_mult, dtype=None,
    )


def assert_grads_close(got: dict, ref: dict, label: str) -> None:
    """Parameter gradients leaf for leaf ({path: array} both), as the training step's comparison."""
    assert set(got) == set(ref), (label, sorted(set(got) ^ set(ref))[:5])
    whole = np.sqrt(sum(float(np.sum(r.astype(np.float64) ** 2)) for r in ref.values()))
    assert whole > 0, label
    diff2 = 0.0
    for k in sorted(ref):
        assert got[k].shape == ref[k].shape, (label, k)
        d = float(np.linalg.norm((got[k] - ref[k]).astype(np.float64)))
        diff2 += d * d
        assert d <= GRAD_LEAF * float(np.linalg.norm(ref[k])) + GRAD_FLOOR * whole, (label, "/".join(k), d)
    print(label, "gradient, relative to its norm:", np.sqrt(diff2) / whole)
    assert np.sqrt(diff2) <= GRAD_WHOLE * whole, (label, np.sqrt(diff2) / whole)


def assert_outputs_close(got, ref, label: str) -> None:
    got, ref = [t.detach().float().numpy() for t in got], [np.asarray(r, np.float32) for r in ref]
    assert len(got) == len(ref), label
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, (label, i, a.shape, b.shape)
        print(label, i, "max abs error:", float(np.abs(a - b).max()))
        np.testing.assert_allclose(a, b, atol=OUT_TOL, rtol=OUT_TOL, err_msg=f"{label} output {i}")


def port_grads(port, got: dict, prefix: str) -> dict:
    """The port's gradients ({name in the encoder: tensor}) as {JAX path under `prefix`: array}."""
    return flat(to_jax_tree(port, got)["params"][prefix])


# ---------------------------------------------------------------------------
# bench_encoder_stages
# ---------------------------------------------------------------------------


def _jax_encoder_rows(w) -> dict:
    """scripts/bench_encoder_stages.py's sub-graphs: {row: () -> outputs or gradients}."""
    from transplat_tpu.geometry.projection import unnormalize_intrinsics
    from transplat_tpu.model.backbone.multiview import BackboneMultiview, normalize_images
    from transplat_tpu.model.dav2 import DepthAnythingV2
    from transplat_tpu.ops.interpolate import resize_bilinear

    cfg, p, bs = w["jcfg"], w["variables"]["params"], w["variables"]["batch_stats"]
    images, intrinsics, extrinsics, near, far = w["ctx"]
    b, v, h, wd, _ = images.shape
    intr_px = unnormalize_intrinsics(intrinsics, (h, wd))
    camk = jnp.broadcast_to(jnp.eye(4), (b, v, 4, 4)).at[..., :3, :3].set(intr_px)
    img2world = extrinsics @ jnp.linalg.inv(camk)
    backbone, dav2, dpred = (BackboneMultiview(feature_channels=cfg.d_feature), DepthAnythingV2(cfg.dav2_encoder),
                             jax_depth_predictor(cfg))

    def run_backbone(params):
        return backbone.apply({"params": params["backbone"], "batch_stats": bs.get("backbone", {})}, images,
                              img2world, attn_splits=cfg.multiview_trans_attn_split, train=False)

    def run_dav2(params):
        da_in = normalize_images(images)[..., jnp.array([2, 0, 1])]
        da_in = resize_bilinear(da_in.reshape(b * v, h, wd, 3), (cfg.dav2_input_size, cfg.dav2_input_size),
                                align_corners=True)
        return dav2.apply({"params": params["da_model"]}, da_in)

    def compute():
        (trans, cnn), bb_grad = outputs_and_grad(run_backbone)(p)
        raw_depth, dino = jax.jit(run_dav2)(p)
        da_depth = resize_bilinear(raw_depth[..., None], (h, wd), align_corners=True)
        flat_ = da_depth.reshape(b * v, -1)
        lo, hi = flat_.min(axis=-1, keepdims=True), flat_.max(axis=-1, keepdims=True)
        da_depth = ((flat_ - lo) / (hi - lo + 1e-8)).reshape(b, v, h, wd, 1)

        def run_dpred(params):
            return dpred.apply({"params": params["depth_predictor"], "batch_stats": bs.get("depth_predictor", {})},
                               trans, cnn, images, intrinsics, extrinsics, near, far, da_depth,
                               dino.reshape(b, v, *dino.shape[1:]), train=False, deterministic=True)[:3]

        dp_out, dp_grad = outputs_and_grad(run_dpred)(p)
        return {
            "backbone fwd": (trans, cnn), "backbone fwd+bwd": bb_grad["backbone"],
            "dav2 fwd (frozen)": (raw_depth, dino),
            "depth_pred fwd": dp_out, "depth_pred fwd+bwd": dp_grad["depth_predictor"],
        }

    row = lazy(compute)
    return {name: row(name) for name in bench_encoder_stages.ROWS}


@pytest.fixture(scope="module")
def encoder_rows(weights):
    return bench_encoder_stages.subgraphs(weights["port"], weights["batch"], "cpu"), _jax_encoder_rows(weights)


@pytest.mark.parametrize("row", bench_encoder_stages.ROWS)
def test_encoder_stage_subgraph_matches_jax(row, weights, encoder_rows):
    port_rows, jax_rows = encoder_rows
    got, ref = port_rows[row](), jax_rows[row]()
    if row.endswith("fwd+bwd"):
        prefix = {"backbone": "backbone", "depth_pred": "depth_predictor"}[row.split()[0]]
        assert_grads_close(port_grads(weights["port"], got, prefix), flat(ref), row)
    else:
        assert_outputs_close(list(got), list(ref), row)
