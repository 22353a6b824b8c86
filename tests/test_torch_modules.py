"""Port modules (transplat_tpu_torch.model, ops) vs the JAX package, module by
module, at narrow widths. Weights are random with the JAX modules' shapes
(no zero-initialised offsets or norm scales that would hide a path), and go
across through `load_jax_variables`. Inputs are numpy arrays from a
seed; everything is float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transplat_tpu_torch.convert import load_jax_variables


def random_variables(jax_module, *args, seed=0, **kwargs):
    """Random JAX variables of `jax_module`'s shapes, as numpy (shapes from
    jax.eval_shape: running the JAX initialisers op by op costs tens of
    seconds here). Kernels N(0, 1/fan_in), biases and tokens N(0, 0.05),
    norm and layer scales 1 + N(0, 0.05), BatchNorm statistics random."""
    def init(*arrays):
        it = iter(arrays)
        full = [next(it) if isinstance(a, np.ndarray) else a for a in args]
        return jax_module.init(jax.random.PRNGKey(0), *full, **kwargs)

    shapes = jax.eval_shape(init, *(jnp.asarray(a) for a in args if isinstance(a, np.ndarray)))
    rng = np.random.default_rng(seed)

    def leaf(name, shape, stats):
        if stats:
            return rng.uniform(0.5, 2.0, shape) if name == "var" else rng.normal(0.0, 0.5, shape)
        if name == "kernel":
            return rng.normal(0.0, float(np.prod(shape[:-1])) ** -0.5, shape)
        if name in ("scale", "gamma"):
            return 1.0 + rng.normal(0.0, 0.05, shape)
        return rng.normal(0.0, 0.05, shape)

    def walk(node, stats):
        return {
            k: walk(v, stats) if hasattr(v, "items") else leaf(k, v.shape, stats).astype(np.float32)
            for k, v in node.items()
        }

    return {name: walk(tree, name == "batch_stats") for name, tree in shapes.items()}


def init_pair(jax_module, port_module, *args, seed=0, **kwargs):
    """Random JAX variables for `jax_module`, loaded into `port_module`."""
    variables = random_variables(jax_module, *args, seed=seed, **kwargs)
    load_jax_variables(port_module, variables)
    port_module.eval()
    return variables


def rand(shape, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def nchw(a):
    return t(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def close(port, ref, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


# Tolerances: float32 convolutions and matmuls summed in other orders than
# XLA's; 1e-5 absolute + relative for shallow modules, looser (stated per
# test) where many layers compound it.


def test_layers_and_cam_encoder():
    from transplat_tpu.model import cam_encoder as jce
    from transplat_tpu.model import layers as jl
    from transplat_tpu_torch.model import cam_encoder as tce
    from transplat_tpu_torch.model import layers as tl

    x = rand((3, 10), 1)
    port = tl.Mlp(10, 12, 5)
    v = init_pair(jl.Mlp(12, 5), port, x)
    close(port(t(x)), jl.Mlp(12, 5).apply(v, x))

    x = rand((4, 16), 2)
    v = random_variables(jl.FFN(16, 32), x)
    close(_loaded(tl.FFN(16, 32), v)(t(x)), jl.FFN(16, 32).apply(v, x))

    feat, cam = rand((2, 6, 5, 24), 3), rand((2, 16), 4)
    jm = jce.CamParamEncoder(mid_channels=128, embed_dims=16)
    v = random_variables(jm, feat, cam, seed=1)
    port = _loaded(tce.CamParamEncoder(24, 128, 16), v)
    close(port(nchw(feat), t(cam)).permute(0, 2, 3, 1), jm.apply(v, feat, cam), atol=2e-5)


def _loaded(module, variables):
    load_jax_variables(module, variables)
    return module.eval()


@pytest.mark.parametrize("shift,multi", [(False, False), (True, False), (True, True)])
def test_window_attention(shift, multi):
    from transplat_tpu.ops.window import window_attention as jw
    from transplat_tpu_torch.ops.window import window_attention as tw

    h = w = 8
    q = rand((2, h * w, 16), 1)
    kv_shape = (2, 2, h * w, 16) if multi else (2, h * w, 16)
    k, v = rand(kv_shape, 2), rand(kv_shape, 3)
    close(tw(t(q), t(k), t(v), h, w, 2, shift), jw(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, w, 2, shift))


def test_interpolate():
    from transplat_tpu.ops import interpolate as ji
    from transplat_tpu_torch.ops import interpolate as ti

    x = rand((2, 7, 9, 3), 1)
    for shape, ac in (((12, 5), True), ((4, 16), False)):
        close(ti.resize_bilinear(t(x), shape, ac), ji.resize_bilinear(jnp.asarray(x), shape, ac))
    close(ti.resize_bicubic_torch(t(x), (3, 4), (0.4, 0.45)), ji.resize_bicubic_torch(jnp.asarray(x), (3, 4), (0.4, 0.45)))
    close(ti.upsample_nearest(t(x), 3), ji.upsample_nearest(jnp.asarray(x), 3))
    loc = rand((20, 2), 2, -0.2, 1.2)
    for ac in (False, True):
        close(ti.grid_sample(t(x[0]), t(loc), ac), ji.grid_sample(jnp.asarray(x[0]), jnp.asarray(loc), ac))


def test_backbone():
    from transplat_tpu.model.backbone.multiview import BackboneMultiview as JB
    from transplat_tpu_torch.model.backbone.multiview import BackboneMultiview as TB

    images = rand((1, 2, 32, 32, 3), 1, 0.0, 1.0)
    i2w = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1)) + rand((1, 2, 4, 4), 2) * 0.1
    jm = JB(feature_channels=16, num_transformer_layers=2)
    v = random_variables(jm, images, i2w, seed=2)
    port = _loaded(TB(16, num_transformer_layers=2), v)
    tr_t, cnn_t = port(t(images), t(i2w))
    tr_j, cnn_j = jm.apply(v, images, i2w)
    # Seven conv + instance-norm stages and two transformer blocks: 1e-4.
    close(cnn_t, cnn_j, atol=1e-4, rtol=1e-4)
    close(tr_t, tr_j, atol=1e-4, rtol=1e-4)


def test_dav2_vits():
    from transplat_tpu.model.dav2 import DepthAnythingV2 as JD
    from transplat_tpu_torch.model.dav2 import DepthAnythingV2 as TD

    x = rand((2, 28, 42, 3), 1)
    jm = JD("vits")
    v = random_variables(jm, x, seed=3)
    port = _loaded(TD("vits"), v)
    with torch.no_grad():
        depth_t, feat_t = port(t(x))
    depth_j, feat_j = jax.jit(jm.apply)(v, x)
    # 12 ViT blocks + the DPT head: relative 1e-4.
    close(feat_t, feat_j, atol=1e-4, rtol=1e-4)
    close(depth_t, depth_j, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mult,attn", [((1, 1), (2,)), ((1, 1, 1), (4,))])
def test_unet(mult, attn):
    from transplat_tpu.model.unet import UNetModel as JU
    from transplat_tpu_torch.model.unet import UNetModel as TU

    x = rand((2, 16, 16, 8), 1)
    jm = JU(model_channels=16, out_channels=16, attention_resolutions=attn, channel_mult=mult, num_frames=2)
    v = random_variables(jm, x, seed=4)
    port = _loaded(TU(8, 16, 16, 1, attn, mult, num_frames=2), v)
    with torch.no_grad():
        out = port(nchw(x)).permute(0, 2, 3, 1)
    close(out, jm.apply(v, x), atol=1e-4, rtol=1e-4)


def _uv_inputs(n, q_side, c, d, seed):
    q = q_side * q_side
    key, value, pos = rand((n, q, c), seed), rand((n, q, c), seed + 1), rand((n, q, c), seed + 2)
    grid = rand((n, q, d, 2), seed + 3, -0.1, 1.1)
    rx = (np.arange(q_side, dtype=np.float32) + 0.5) / q_side
    ref = np.stack(np.meshgrid(rx, rx, indexing="xy"), -1).reshape(q, 2)
    return key, value, pos, grid, np.broadcast_to(ref, (n, q, 2)).copy()


def test_uv_matcher():
    from transplat_tpu.model.uv_transformer import UVMatcher as JM
    from transplat_tpu_torch.model.uv_transformer import UVMatcher as TM

    key, value, pos, grid, ref = _uv_inputs(2, 8, 16, 16, 1)
    jm = JM(embed_dims=16, num_depth=16)
    v = random_variables(jm, key[0], value[0], pos[0], grid[0], ref[0], (8, 8), seed=5)
    port = _loaded(TM(16, 16), v)
    with torch.no_grad():
        out = port(t(key), t(value), t(pos), t(grid), t(ref), (8, 8))
    apply = jax.jit(lambda v, *a: jm.apply(v, *a, (8, 8)))
    for i in range(2):
        close(out[i], apply(v, key[i], value[i], pos[i], grid[i], ref[i]), atol=1e-4, rtol=1e-4)


def test_depth_predictor():
    from transplat_tpu.model.depth_predictor import DepthPredictor as JP
    from transplat_tpu_torch.model.depth_predictor import DepthPredictor as TP

    kw = dict(
        feature_channels=16, num_depth_candidates=16, costvolume_unet_feat_dim=16,
        costvolume_unet_channel_mult=(1, 1), costvolume_unet_attn_res=(2,), gaussian_raw_channels=22,
        depth_unet_feat_dim=8, depth_unet_attn_res=(4,), depth_unet_channel_mult=(1, 1, 1),
    )
    b, v_, hf, big = 1, 2, 8, 32
    feats, cnn = rand((b, v_, hf, hf, 16), 1), rand((b, v_, hf, hf, 16), 2)
    images = rand((b, v_, big, big, 3), 3, 0.0, 1.0)
    intr = np.tile(np.array([[1.1, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]], np.float32), (b, v_, 1, 1))
    extr = np.tile(np.eye(4, dtype=np.float32), (b, v_, 1, 1))
    extr[:, 1, 0, 3] = 0.3
    near, far = np.full((b, v_), 1.0, np.float32), np.full((b, v_), 100.0, np.float32)
    da = rand((b, v_, big, big, 1), 4, 0.0, 1.0)
    dino = rand((b, v_, 8, 8, 32), 5)
    args = (feats, cnn, images, intr, extr, near, far, da, dino)
    jm = JP(**kw)
    v = random_variables(jm, *args, seed=6)
    port = _loaded(TP(**kw, dino_channels=32), v)
    with torch.no_grad():
        out_t = port(*(t(a) for a in args))
    out_j = jax.jit(jm.apply)(v, *args)
    # Matching, two U-Nets and the heads compound float32 reassociation:
    # 1e-4. Depths are 1 / disparity with disparities down to 1/far = 0.01,
    # so they are compared as disparities.
    close(1.0 / out_t[0], 1.0 / np.asarray(out_j[0]), atol=1e-5, rtol=1e-4)
    for a, b_ in zip(out_t[1:3], out_j[1:3]):
        close(a, b_, atol=1e-4, rtol=1e-4)
    close(out_t[3]["pdf"], out_j[3]["pdf"], atol=1e-5, rtol=1e-4)


def test_adapter():
    from transplat_tpu.model import adapter as ja
    from transplat_tpu_torch.model import adapter as ta

    cfg_j, cfg_t = ja.GaussianAdapterCfg(sh_degree=2), ta.GaussianAdapterCfg(sh_degree=2)
    b, v, r = 1, 2, 30
    extr = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    extr[:, :, :3, 3] = rand((b, v, 3), 1) * 0.3
    intr = np.tile(np.array([[1.1, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (b, v, 1, 1))
    coords = rand((b, v, r, 2), 2, 0.0, 1.0)
    depths = rand((b, v, r), 3, 1.0, 10.0)
    opac = rand((b, v, r), 4, 0.0, 1.0)
    raw = rand((b, v, r, cfg_t.d_in), 5)
    out_t = ta.adapt_gaussians(cfg_t, *(t(a) for a in (extr, intr, coords, depths, opac, raw)), (16, 16))
    out_j = ja.adapt_gaussians(cfg_j, *(jnp.asarray(a) for a in (extr, intr, coords, depths, opac, raw)), (16, 16))
    for k in out_j:
        close(out_t[k], out_j[k], atol=1e-5, rtol=1e-5)
