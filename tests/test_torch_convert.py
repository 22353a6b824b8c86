"""The port's checkpoint converters (transplat_tpu_torch/convert/*.py and
`python -m transplat_tpu_torch.convert_weights`) against the JAX package's
(transplat_tpu/convert/*.py, scripts/convert_weights.py).

The reference implementation's modules are not available here, so the
state dicts in its names and layouts are built from JAX trees: `_Ref` walks
a seeded tree of the tiny encoder's shapes (jax.eval_shape of the JAX
module's init, filled from numpy) the way each JAX converter walks a state
dict, and writes every leaf back under its reference key in the torch
layout. JAX's own converters check the helper: each returns the tree it
was built from, leaf for leaf, with no unconverted key. The converters fix
some depths: the backbone transformer has 6 layers, the fine UV matcher 2,
DAv2 12 blocks for vits and vitb; widths are small (the tiny encoder, and
for vitb a narrowed DAV2_CONFIGS entry).

On those dicts the port's converters equal JAX's bit for bit (the same
keys, dtypes, shapes and values; the same types where a Lightning
checkpoint's `losses.*` entries pass through), their errors read the same,
both command lines write .npy files that load to equal trees and print the
same --dry-run lines, and converted Lightning and DAv2 trees load into the
port's encoder as JAX merges them (JAX's loader itself refuses them: see
`test_converted_trees_load_into_the_port`).
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_cases import seeded_lpips_state
from test_torch_encoder import _tiny_cfgs
from test_torch_modules import random_variables
from transplat_tpu.convert import backbone as jax_backbone
from transplat_tpu.convert import dav2 as jax_dav2
from transplat_tpu.convert import depth_predictor as jax_dp
from transplat_tpu.convert import encoder as jax_encoder
from transplat_tpu.convert import unet as jax_unet
from transplat_tpu.convert import uv as jax_uv
from transplat_tpu_torch import convert_weights
from transplat_tpu_torch.convert import backbone, dav2, depth_predictor, encoder, unet, uv

REPO = Path(__file__).resolve().parents[1]
CTX_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")
# The tiny encoder's U-Nets (tests/test_torch_encoder.py _tiny_cfgs).
UNET_KW = dict(costvolume_unet_channel_mult=(1, 1), costvolume_unet_attn_res=(2,),
               depth_unet_channel_mult=(1, 1, 1), depth_unet_attn_res=(4,))
# The published configuration's U-Nets: the converters' defaults, so the only
# ones the command line's `--kind lightning` converts.
PUBLISHED_UNET_KW = dict(costvolume_unet_channel_mult=(1, 1, 1), costvolume_unet_attn_res=(4,),
                         depth_unet_channel_mult=(1, 1, 1, 1, 1), depth_unet_attn_res=(16,))
# DAv2 vitb narrowed (12 blocks, as vitb has): the converters read no width.
NARROW_VITB = dict(embed_dim=32, num_heads=2, features=16, out_channels=(8, 16, 24, 32))
CNN_LAYERS = ("layer1.0", "layer1.1", "layer2.0", "layer2.1", "layer3.0", "layer3.1")
# The reference's DPT head builds refinenet4 with both residual units, but its
# forward never runs the first (refinenet4 fuses no skip input), so the JAX
# module has no such parameters; both converters still emit them.
DEAD_DAV2 = tuple(f"depth_head/refinenet4/resConfUnit1/{c}/{p}" for c in ("conv1", "conv2") for p in ("kernel", "bias"))


# ---------------------------------------------------------------------------
# reference-named state dicts from JAX trees
# ---------------------------------------------------------------------------


def _get(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _has(tree, path):
    try:
        _get(tree, path)
        return True
    except KeyError:
        return False


class _Ref:
    """Writes reference keys into `sd` from the Flax tree `p` (and BatchNorm
    statistics `s`), each method the inverse of one converter primitive:
    `t` is the torch key, `f` the Flax path, both under the prefixes."""

    def __init__(self, p, s=None, sd=None, tp="", fp=""):
        self.p, self.s, self.sd, self.tp, self.fp = p, s or {}, {} if sd is None else sd, tp, fp

    def at(self, t: str, f: str) -> "_Ref":
        return _Ref(self.p, self.s, self.sd, f"{self.tp}{t}.", f"{self.fp}{f}/")

    def has(self, f: str) -> bool:
        return _has(self.p, self.fp + f)

    def leaf(self, t, f, fn=lambda x: x, tree=None):
        self.sd[self.tp + t] = np.ascontiguousarray(fn(np.asarray(_get(self.p if tree is None else tree, self.fp + f))))

    def _bias(self, t, f):
        if self.has(f"{f}/bias"):
            self.leaf(f"{t}.bias", f"{f}/bias")

    def conv(self, t, f):  # kernel (kh, kw, I, O) -> weight (O, I, kh, kw)
        self.leaf(f"{t}.weight", f"{f}/kernel", lambda k: k.transpose(3, 2, 0, 1))
        self._bias(t, f)

    def conv_t(self, t, f):  # kernel (kh, kw, I, O) -> ConvTranspose2d weight (I, O, kh, kw), flipped
        self.leaf(f"{t}.weight", f"{f}/kernel", lambda k: k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
        self._bias(t, f)

    def linear(self, t, f):  # kernel (I, O) -> weight (O, I)
        self.leaf(f"{t}.weight", f"{f}/kernel", lambda k: k.T)
        self._bias(t, f)

    def conv1d(self, t, f):  # Dense kernel (I, O) -> Conv1d weight (O, I, 1)
        self.leaf(f"{t}.weight", f"{f}/kernel", lambda k: k.T[:, :, None])
        self._bias(t, f)

    def norm(self, t, f):
        self.leaf(f"{t}.weight", f"{f}/scale")
        self.leaf(f"{t}.bias", f"{f}/bias")

    def batchnorm(self, t, f):
        self.norm(t, f)
        self.leaf(f"{t}.running_mean", f"{f}/mean", tree=self.s)
        self.leaf(f"{t}.running_var", f"{f}/var", tree=self.s)
        self.sd[f"{self.tp}{t}.num_batches_tracked"] = np.array(7, np.int64)  # torch bookkeeping, ignored


def ref_cnn(r, base="backbone"):
    r.conv(f"{base}.conv1", f"{base}/conv1")
    for t in CNN_LAYERS:
        f = t.replace(".", "_")
        for c in ("conv1", "conv2"):
            r.conv(f"{base}.{t}.{c}", f"{base}/{f}/{c}")
        if r.has(f"{base}/{f}/downsample"):
            r.conv(f"{base}.{t}.downsample.0", f"{base}/{f}/downsample")
    r.conv(f"{base}.conv2", f"{base}/conv2")


def ref_cam_param_encoder(r, base="cam_param_encoder"):
    r.batchnorm(f"{base}.bn", f"{base}/bn")
    r.conv(f"{base}.reduce_conv.0", f"{base}/reduce_conv_0")
    r.batchnorm(f"{base}.reduce_conv.1", f"{base}/reduce_bn")
    for fc in ("fc1", "fc2"):
        r.linear(f"{base}.context_mlp.{fc}", f"{base}/context_mlp/{fc}")
    for c in ("conv_reduce", "conv_expand"):
        r.conv(f"{base}.context_se.{c}", f"{base}/context_se/{c}")
    r.conv(f"{base}.context_conv", f"{base}/context_conv")


def ref_transformer(r, base="transformer", num_layers=6):
    for i in range(num_layers):
        t, f = f"{base}.layers.{i}", f"{base}/layer_{i}"
        for blk in ("self_attn", "cross_attn_ffn"):
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                r.linear(f"{t}.{blk}.{proj}", f"{f}/{blk}/{proj}")
            r.norm(f"{t}.{blk}.norm1", f"{f}/{blk}/norm1")
        r.linear(f"{t}.cross_attn_ffn.mlp.0", f"{f}/cross_attn_ffn/mlp_0")
        r.linear(f"{t}.cross_attn_ffn.mlp.2", f"{f}/cross_attn_ffn/mlp_2")
        r.norm(f"{t}.cross_attn_ffn.norm2", f"{f}/cross_attn_ffn/norm2")


def ref_backbone(r):
    ref_cnn(r)
    ref_cam_param_encoder(r)
    ref_transformer(r)


def ref_dav2(r, rng, depth=12):
    r.conv("pretrained.patch_embed.proj", "pretrained/patch_embed")
    r.leaf("pretrained.cls_token", "pretrained/cls_token")
    r.leaf("pretrained.pos_embed", "pretrained/pos_embed")
    r.sd[r.tp + "pretrained.mask_token"] = rng.normal(0, 0.02, (1, r.sd[r.tp + "pretrained.cls_token"].shape[-1])).astype(np.float32)
    for i in range(depth):
        t, f = f"pretrained.blocks.{i}", f"pretrained/block_{i}"
        r.norm(f"{t}.norm1", f"{f}/norm1")
        r.linear(f"{t}.attn.qkv", f"{f}/attn/qkv")
        r.linear(f"{t}.attn.proj", f"{f}/attn/proj")
        r.leaf(f"{t}.ls1.gamma", f"{f}/ls1/gamma")
        r.norm(f"{t}.norm2", f"{f}/norm2")
        r.linear(f"{t}.mlp.fc1", f"{f}/mlp_fc1")
        r.linear(f"{t}.mlp.fc2", f"{f}/mlp_fc2")
        r.leaf(f"{t}.ls2.gamma", f"{f}/ls2/gamma")
    r.norm("pretrained.norm", "pretrained/norm")
    for i in range(4):
        r.conv(f"depth_head.projects.{i}", f"depth_head/project_{i}")
    r.conv_t("depth_head.resize_layers.0", "depth_head/resize_0")
    r.conv_t("depth_head.resize_layers.1", "depth_head/resize_1")
    r.conv("depth_head.resize_layers.3", "depth_head/resize_3")
    for i in range(4):
        r.conv(f"depth_head.scratch.layer{i + 1}_rn", f"depth_head/layer{i + 1}_rn")
    for i in range(1, 5):
        t, f = f"depth_head.scratch.refinenet{i}", f"depth_head/refinenet{i}"
        for unit in ("resConfUnit1", "resConfUnit2"):
            for c in ("conv1", "conv2"):
                if r.has(f"{f}/{unit}"):
                    r.conv(f"{t}.{unit}.{c}", f"{f}/{unit}/{c}")
                else:  # the reference's unused unit (DEAD_DAV2): seeded values of the live unit's shapes
                    live = _get(r.p, f"{r.fp}{f}/resConfUnit2/{c}")
                    dead = {k: rng.normal(0, 0.05, v.shape).astype(np.float32) for k, v in live.items()}
                    _Ref({"dead": dead}, sd=r.sd, tp=r.tp).conv(f"{t}.{unit}.{c}", "dead")
        r.conv(f"{t}.out_conv", f"{f}/out_conv")
    r.conv("depth_head.scratch.output_conv1", "depth_head/output_conv1")
    r.conv("depth_head.scratch.output_conv2.0", "depth_head/output_conv2_0")
    r.conv("depth_head.scratch.output_conv2.2", "depth_head/output_conv2_2")


def _ref_resblock(r, t, f):
    r.conv(f"{t}.in_layers.0", f"{f}/in_conv")
    r.norm(f"{t}.in_layers.1", f"{f}/in_norm")
    r.conv(f"{t}.out_layers.0", f"{f}/out_conv")
    r.norm(f"{t}.out_layers.1", f"{f}/out_norm")
    if r.has(f"{f}/skip"):
        r.conv(f"{t}.skip_connection", f"{f}/skip")


def _ref_attn(r, t, f):
    r.conv1d(f"{t}.qkv", f"{f}/qkv")
    r.conv1d(f"{t}.proj_out", f"{f}/proj_out")
    r.norm(f"{t}.norm", f"{f}/norm")


def ref_unet(r, channel_mult, attention_resolutions, num_res_blocks=1):
    r.conv("input_blocks.0.0", "in_conv")
    idx, ds, levels = 1, 1, len(channel_mult)
    for level in range(levels):
        for i in range(num_res_blocks):
            _ref_resblock(r, f"input_blocks.{idx}.0", f"down_{level}_{i}")
            if ds in attention_resolutions:
                _ref_attn(r, f"input_blocks.{idx}.1", f"down_{level}_{i}_attn")
            idx += 1
        if level != levels - 1:
            r.conv(f"input_blocks.{idx}.0.op", f"downsample_{level}")
            idx, ds = idx + 1, ds * 2
    _ref_resblock(r, "middle_block.0", "middle_0")
    _ref_resblock(r, "middle_block.2", "middle_1")
    o = 0
    for level in reversed(range(levels)):
        for i in range(num_res_blocks + 1):
            _ref_resblock(r, f"output_blocks.{o}.0", f"up_{level}_{i}")
            sub = 1
            if ds in attention_resolutions:
                _ref_attn(r, f"output_blocks.{o}.{sub}", f"up_{level}_{i}_attn")
                sub += 1
            if level and i == num_res_blocks:
                r.conv(f"output_blocks.{o}.{sub}.conv", f"upsample_{level}")
                ds //= 2
            o += 1
    r.conv("out.0", "out_conv")
    r.norm("out.1", "out_norm")


def ref_uv(uv_tree, rng, num_fine_layers=2):
    """(coarse, fine) UVTransformer state dicts of the UV matcher's tree."""
    d = uv_tree["fine_0"]["norm0"]["scale"].shape[0]
    coarse = {"encoder.layers.0.attentions.0.attention_weights.weight": rng.normal(0, 0.05, (1, d)).astype(np.float32),
              "encoder.layers.0.attentions.0.attention_weights.bias": rng.normal(0, 0.05, (1,)).astype(np.float32)}
    r = _Ref(uv_tree)
    for i in range(num_fine_layers):
        t, f = f"encoder.layers.{i}", f"fine_{i}"
        for a, name in ((0, "self_attn"), (1, "cross_attn")):
            for lin in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
                r.linear(f"{t}.attentions.{a}.{lin}", f"{f}/{name}/{lin}")
        r.linear(f"{t}.ffns.0.layers.0.0", f"{f}/ffn/fc1")
        r.linear(f"{t}.ffns.0.layers.1", f"{f}/ffn/fc2")
        for n in range(3):
            r.norm(f"{t}.norms.{n}", f"{f}/norm{n}")
    return coarse, r.sd


def ref_depth_predictor(r, rng, unet_kw=UNET_KW):
    r.conv("corr_refine_net.0", "corr_conv_in")
    r.norm("corr_refine_net.1", "corr_norm_in")
    ref_unet(r.at("corr_refine_net.3", "corr_unet"), unet_kw["costvolume_unet_channel_mult"], unet_kw["costvolume_unet_attn_res"])
    r.conv("corr_refine_net.4", "corr_conv_out")
    r.conv("regressor_residual", "regressor_residual")
    r.conv("depth_head_lowres.0", "depth_head_0")
    r.conv("depth_head_lowres.2", "depth_head_2")
    r.conv("upsampler.0", "upsampler_conv")
    r.conv("proj_feature", "proj_feature")
    r.conv("refine_unet.0", "refine_conv_in")
    r.norm("refine_unet.1", "refine_norm_in")
    ref_unet(r.at("refine_unet.3", "refine_unet"), unet_kw["depth_unet_channel_mult"], unet_kw["depth_unet_attn_res"])
    for name in ("to_gaussians", "to_disparity"):
        r.conv(f"{name}.0", f"{name}_0")
        r.conv(f"{name}.2", f"{name}_2")
    coarse, fine = ref_uv(_get(r.p, r.fp + "uv_matcher"), rng)
    r.sd.update({f"{r.tp}coarse_transformer.{k}": v for k, v in coarse.items()})
    r.sd.update({f"{r.tp}fine_transformer.{k}": v for k, v in fine.items()})
    ref_cam_param_encoder(r)


def ref_encoder(variables, rng, unet_kw=UNET_KW):
    """An EncoderTrans state dict (backbone.*, da_model.*, depth_predictor.*)."""
    r = _Ref(variables["params"], variables["batch_stats"])
    ref_backbone(r.at("backbone", "backbone"))
    ref_dav2(r.at("da_model", "da_model"), rng)
    ref_depth_predictor(r.at("depth_predictor", "depth_predictor"), rng, unet_kw)
    return r.sd


def ref_lightning(variables, rng, lpips_seed=3, unet_kw=UNET_KW):
    sd = {f"encoder.{k}": v for k, v in ref_encoder(variables, rng, unet_kw).items()}
    sd.update(seeded_lpips_state("lpips", "losses.0.lpips.", seed=lpips_seed))
    return {"state_dict": sd, "epoch": 3, "global_step": 1200}


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_tree():
    """Seeded JAX variables of the tiny encoder (DAv2 vits at its own widths,
    12 blocks; the backbone transformer's 6 layers; 2 fine UV layers)."""
    from transplat_tpu.model.encoder import EncoderTranSplat as JEnc
    from transplat_tpu_torch.dataset import synthetic_batch

    jcfg, _ = _tiny_cfgs()
    batch = synthetic_batch(0, image_shape=(64, 64), num_target=1)
    return random_variables(JEnc(jcfg), *(batch["context"][k] for k in CTX_KEYS), seed=51)


@pytest.fixture(scope="module")
def vitb_tree():
    """A DAv2 vitb tree at narrowed widths."""
    from transplat_tpu.model.dav2 import DAV2_CONFIGS, DepthAnythingV2

    mp = pytest.MonkeyPatch()
    mp.setitem(DAV2_CONFIGS, "vitb", NARROW_VITB)
    try:
        return random_variables(DepthAnythingV2(encoder="vitb"), np.zeros((1, 28, 28, 3), np.float32), seed=52)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def published_tree():
    """Seeded JAX variables of an encoder with the published configuration's
    U-Nets and DAv2 variant (vitb, narrowed) at the tiny encoder's widths."""
    from transplat_tpu.model.adapter import GaussianAdapterCfg
    from transplat_tpu.model.dav2 import DAV2_CONFIGS
    from transplat_tpu.model.encoder import EncoderCfg, EncoderTranSplat as JEnc
    from transplat_tpu_torch.dataset import synthetic_batch

    cfg = EncoderCfg(d_feature=16, num_depth_candidates=16, costvolume_unet_feat_dim=16, depth_unet_feat_dim=8,
                     dav2_input_size=28, gaussian_adapter=GaussianAdapterCfg(sh_degree=1))
    assert cfg.dav2_encoder == "vitb" and all(tuple(getattr(cfg, k)) == v for k, v in PUBLISHED_UNET_KW.items())
    batch = synthetic_batch(0, image_shape=(64, 64), num_target=1)
    mp = pytest.MonkeyPatch()
    mp.setitem(DAV2_CONFIGS, "vitb", NARROW_VITB)
    try:
        return random_variables(JEnc(cfg), *(batch["context"][k] for k in CTX_KEYS), seed=53)
    finally:
        mp.undo()


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def assert_trees_identical(got, want):
    """Same keys, leaf types, dtypes, shapes and values."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert type(g) is type(w), k
        g, w = (x.numpy() if isinstance(x, torch.Tensor) else x for x in (g, w))
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _without(tree, paths):
    out = {k: v for k, v in dict(_leaves(tree)).items() if k not in paths}
    nested: dict = {}
    for k, v in out.items():
        node = nested
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return nested


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else np.asarray(v, np.float32) for k, v in tree.items()}


def _both(jax_fn, port_fn, *args, **kwargs):
    want, got = jax_fn(*args, **kwargs), port_fn(*args, **kwargs)
    assert_trees_identical(got, want)
    return want


# ---------------------------------------------------------------------------
# the converters, module by module
# ---------------------------------------------------------------------------


def test_backbone_and_unimatch(tiny_tree):
    params, stats = tiny_tree["params"]["backbone"], tiny_tree["batch_stats"]["backbone"]
    r = _Ref(params, stats)
    ref_backbone(r)
    want = _both(jax_backbone.convert_backbone_multiview, backbone.convert_backbone_multiview, r.sd)
    assert_trees_identical(want, _f32({"params": params, "batch_stats": stats}))  # the helper is the inverse
    assert len(want["params"]["transformer"]) == 6

    # a gmdepth checkpoint: CNN + transformer keys beside others of UniMatch's, which stay unread
    gm = {k: v for k, v in r.sd.items() if k.startswith(("backbone.", "transformer."))}
    gm["upsampler.0.weight"] = np.ones((4, 4, 3, 3), np.float32)
    want = _both(jax_backbone.convert_unimatch_checkpoint, backbone.convert_unimatch_checkpoint, gm)
    sub = {k: params[k] for k in ("backbone", "transformer")}
    assert_trees_identical(want, {"params": _f32(sub), "batch_stats": {}})


@pytest.mark.parametrize("variant", ["vits", "vitb"])
def test_dav2(tiny_tree, vitb_tree, variant):
    tree = tiny_tree["params"]["da_model"] if variant == "vits" else vitb_tree["params"]
    r = _Ref(tree)
    ref_dav2(r, np.random.default_rng(2))
    want = _both(jax_dav2.convert_dav2, dav2.convert_dav2, r.sd, encoder=variant)
    assert_trees_identical(_without(want, {f"params/{p}" for p in DEAD_DAV2}), {"params": _f32(tree)})
    assert all(_has(want["params"], p) for p in DEAD_DAV2)


@pytest.mark.parametrize("which", ["corr_unet", "refine_unet"])
def test_unet(tiny_tree, which):
    tree = tiny_tree["params"]["depth_predictor"][which]
    mult, attn = ((UNET_KW["costvolume_unet_channel_mult"], UNET_KW["costvolume_unet_attn_res"]) if which == "corr_unet"
                  else (UNET_KW["depth_unet_channel_mult"], UNET_KW["depth_unet_attn_res"]))
    r = _Ref(tree)
    ref_unet(r, mult, attn)
    want = _both(jax_unet.convert_unet, unet.convert_unet, r.sd, channel_mult=mult, num_res_blocks=1,
                 attention_resolutions=attn)
    assert_trees_identical(want, {"params": _f32(tree)})


def test_uv_matcher(tiny_tree):
    tree = tiny_tree["params"]["depth_predictor"]["uv_matcher"]
    coarse, fine = ref_uv(tree, np.random.default_rng(3))
    want = _both(jax_uv.convert_uv_matcher, uv.convert_uv_matcher, coarse, fine)
    assert_trees_identical(want, {"params": _f32(tree)})


def test_depth_predictor(tiny_tree):
    params, stats = tiny_tree["params"]["depth_predictor"], tiny_tree["batch_stats"]["depth_predictor"]
    r = _Ref(params, stats)
    ref_depth_predictor(r, np.random.default_rng(4))
    want = _both(jax_dp.convert_depth_predictor, depth_predictor.convert_depth_predictor, r.sd, **UNET_KW)
    assert_trees_identical(want, _f32({"params": params, "batch_stats": stats}))


def test_encoder_and_lightning(tiny_tree):
    sd = ref_encoder(tiny_tree, np.random.default_rng(5))
    kw = dict(dav2_encoder="vits", **UNET_KW)
    want = _both(jax_encoder.convert_encoder, encoder.convert_encoder, sd, **kw)
    dead = {f"params/da_model/{p}" for p in DEAD_DAV2}
    assert_trees_identical(_without(want, dead), _f32(tiny_tree))

    # Lightning: raw tensors as torch.load gives them; `losses.*` pass through as they are
    ckpt = ref_lightning(tiny_tree, np.random.default_rng(5))
    ckpt["state_dict"] = {k: torch.from_numpy(v) for k, v in ckpt["state_dict"].items()}
    want = _both(jax_encoder.convert_lightning_checkpoint, encoder.convert_lightning_checkpoint, ckpt, **kw)
    assert_trees_identical(_without(want, dead | {p for p, _ in _leaves(want) if p.startswith("lpips_state/")}),
                           _f32(tiny_tree))
    assert sorted(want["lpips_state"]) == sorted(k for k in ckpt["state_dict"] if k.startswith("losses."))
    assert all(isinstance(v, torch.Tensor) for v in want["lpips_state"].values())
    # a bare state dict works too
    _both(jax_encoder.convert_lightning_checkpoint, encoder.convert_lightning_checkpoint,
          {k: v.numpy() for k, v in ckpt["state_dict"].items()}, **kw)


def test_lightning_published_configuration(published_tree):
    """The converters' defaults (DAv2 vitb, the published U-Nets): what the
    command line converts."""
    ckpt = ref_lightning(published_tree, np.random.default_rng(6), unet_kw=PUBLISHED_UNET_KW)
    want = _both(jax_encoder.convert_lightning_checkpoint, encoder.convert_lightning_checkpoint, ckpt)
    lpips = {f"lpips_state/{k}" for k in ckpt["state_dict"] if k.startswith("losses.")}
    assert_trees_identical(_without(want, {f"params/da_model/{p}" for p in DEAD_DAV2} | lpips), _f32(published_tree))


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_convert_weights", REPO / "scripts" / "convert_weights.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_convert_lpips():
    sd = {k: torch.from_numpy(v) for k, v in seeded_lpips_state("lpips", seed=6).items()}
    sd["scaling_layer.shift"] = torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1)
    sd["unrelated.running"] = torch.zeros(3)  # not an LPIPS key: dropped by both
    want = _both(_jax_script().convert_lpips, convert_weights.convert_lpips, sd)
    assert sorted(want) == sorted(k for k in sd if k != "unrelated.running")
    for fn in (_jax_script().convert_lpips, convert_weights.convert_lpips):
        with pytest.raises(ValueError, match="no lpips VGG keys found in checkpoint"):
            fn({"other.weight": np.zeros(2)})


def _error(fn, *args, **kwargs):
    with pytest.raises((KeyError, ValueError)) as info:
        fn(*args, **kwargs)
    return type(info.value), str(info.value)


def test_errors_match_jax(tiny_tree):
    r = _Ref(tiny_tree["params"]["backbone"], tiny_tree["batch_stats"]["backbone"])
    ref_backbone(r)
    extra = {**r.sd, "transformer.layers.0.self_attn.extra.weight": np.zeros((2, 2), np.float32)}
    want = _error(jax_backbone.convert_backbone_multiview, extra)
    assert want == _error(backbone.convert_backbone_multiview, extra)
    assert want[0] is ValueError and "unconverted keys in BackboneMultiview" in want[1] and "extra.weight" in want[1]

    d = _Ref(tiny_tree["params"]["da_model"])
    ref_dav2(d, np.random.default_rng(7))
    extra = {**d.sd, "depth_head.scratch.stem.weight": np.zeros(2, np.float32)}
    want = _error(jax_dav2.convert_dav2, extra, encoder="vits")
    assert want == _error(dav2.convert_dav2, extra, encoder="vits") and "unconverted keys in DepthAnythingV2" in want[1]
    missing = {k: v for k, v in d.sd.items() if k != "pretrained.blocks.11.ls2.gamma"}
    assert _error(jax_dav2.convert_dav2, missing, encoder="vits") == _error(dav2.convert_dav2, missing, encoder="vits")

    sd = ref_encoder(tiny_tree, np.random.default_rng(7))
    sd["gaussian_adapter.extra"] = np.zeros(2, np.float32)
    want = _error(jax_encoder.convert_encoder, sd, dav2_encoder="vits", **UNET_KW)
    assert want == _error(encoder.convert_encoder, sd, dav2_encoder="vits", **UNET_KW)
    assert "unconverted encoder keys" in want[1]

    no_encoder = {"state_dict": seeded_lpips_state("lpips", "losses.0.lpips.")}
    want = _error(jax_encoder.convert_lightning_checkpoint, no_encoder)
    assert want == _error(encoder.convert_lightning_checkpoint, no_encoder)
    assert want[0] is ValueError and "no 'encoder.' keys found" in want[1]


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------


def _run_jax(args):
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "convert_weights.py"), *args],
                          capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def _run_port(args, capsys):
    assert convert_weights.main(args) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def checkpoints(tiny_tree, vitb_tree, published_tree, tmp_path_factory):
    """torch.save'd checkpoints of each kind, as the reference's tools write them."""
    tmp = tmp_path_factory.mktemp("ckpts")
    rng = np.random.default_rng(8)
    t = lambda sd: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}  # noqa: E731
    d = _Ref(vitb_tree["params"])
    ref_dav2(d, rng)
    b = _Ref(tiny_tree["params"]["backbone"], tiny_tree["batch_stats"]["backbone"])
    ref_backbone(b)
    gm = {k: v for k, v in b.sd.items() if k.startswith(("backbone.", "transformer."))}
    lightning = ref_lightning(published_tree, rng, unet_kw=PUBLISHED_UNET_KW)
    lightning["state_dict"] = t(lightning["state_dict"])
    files = {
        "dav2": (t(d.sd), ["--encoder", "vitb"]),
        "unimatch": ({"model": t(gm), "args": {"num_scales": 1}}, []),
        "lpips": (t(seeded_lpips_state("lpips", seed=9)), []),
        "lightning": (lightning, []),
    }
    out = {}
    for kind, (obj, extra) in files.items():
        path = tmp / f"{kind}.pth"
        torch.save(obj, path)
        out[kind] = (path, extra)
    return out


@pytest.mark.parametrize("kind", ["dav2", "unimatch", "lpips", "lightning"])
def test_command_lines_write_the_same_npy(checkpoints, kind, tmp_path, capsys):
    src, extra = checkpoints[kind]
    jax_out, port_out = tmp_path / "jax.npy", tmp_path / "port.npy"
    assert _run_jax([str(src), "--kind", kind, "--out", str(jax_out), *extra]).strip() == f"wrote {jax_out}"
    assert _run_port([str(src), "--kind", kind, "--out", str(port_out), *extra], capsys).strip() == f"wrote {port_out}"
    want = np.load(jax_out, allow_pickle=True).item()
    assert_trees_identical(np.load(port_out, allow_pickle=True).item(), want)
    lines = _run_jax([str(src), "--kind", kind, "--out", str(jax_out), "--dry-run", *extra]).splitlines()
    assert lines == _run_port([str(src), "--kind", kind, "--out", str(port_out), "--dry-run", *extra], capsys).splitlines()
    assert len(lines) == len(list(_leaves(want))) and lines[0].split(" ")[0] == next(_leaves(want))[0]


def test_port_command_line_runs_without_jax(checkpoints, tmp_path):
    """`python -m transplat_tpu_torch.convert_weights` with `import jax` made
    to fail, as on a machine without JAX."""
    src, _ = checkpoints["lpips"]
    out = tmp_path / "lpips.npy"
    code = ("import runpy, sys; sys.modules['jax'] = None; sys.argv = sys.argv[1:]; "
            "runpy.run_module('transplat_tpu_torch.convert_weights', run_name='__main__')")
    for args in ([], ["--dry-run"]):
        proc = subprocess.run([sys.executable, "-c", code, "convert_weights", str(src), "--kind", "lpips", "--out", str(out),
                               *args], capture_output=True, text=True, cwd=REPO, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]  # an `import jax` anywhere would have raised
    tree = np.load(out, allow_pickle=True).item()
    assert_trees_identical(tree, convert_weights.convert_lpips(torch.load(src)))


# ---------------------------------------------------------------------------
# a converted Lightning tree into the port's encoder
# ---------------------------------------------------------------------------


def test_converted_trees_load_into_the_port(tiny_tree, tmp_path):
    """A converted Lightning tree and a converted DAv2 tree, loaded by the
    port's load_pretrained_variables. JAX's loader refuses what its own
    converter writes: the reference's unused refinenet4 unit (DEAD_DAV2) is
    in no module of either package. The port drops that unit, and loads
    every other leaf as JAX merges the tree without it, bit for bit."""
    import copy

    import jax

    from transplat_tpu.config import CheckpointingCfg as JCkpt
    from transplat_tpu.training import pretrained as jax_pretrained
    from transplat_tpu_torch.config import CheckpointingCfg
    from transplat_tpu_torch.convert import load_jax_variables, to_jax_tree
    from transplat_tpu_torch.model.encoder import EncoderTranSplat
    from transplat_tpu_torch.training import pretrained

    _, tcfg = _tiny_cfgs()
    base = random_variables_like(tiny_tree, seed=12)  # the initial weights the file is merged over

    def port_load(**files):
        port = load_jax_variables(EncoderTranSplat(tcfg, device="cpu"), base)
        lpips_state = pretrained.load_pretrained_variables(port, CheckpointingCfg(**files))
        return to_jax_tree(port), lpips_state

    def jax_load(**files):
        merged, lpips_state = jax_pretrained.load_pretrained_variables(copy.deepcopy(base), JCkpt(**files))
        return jax.tree.map(np.asarray, merged), lpips_state

    ckpt = ref_lightning(tiny_tree, np.random.default_rng(10), lpips_seed=11)
    tree = encoder.convert_lightning_checkpoint(ckpt, dav2_encoder="vits", **UNET_KW)
    dead = {f"params/da_model/{p}" for p in DEAD_DAV2}
    np.save(tmp_path / "lightning.npy", tree, allow_pickle=True)
    np.save(tmp_path / "without_unit.npy", _without(tree, dead), allow_pickle=True)
    with pytest.raises(KeyError, match="pretrained key 'da_model/depth_head/refinenet4/resConfUnit1' not present"):
        jax_load(pretrained_model=str(tmp_path / "lightning.npy"))
    got, got_lpips = port_load(pretrained_model=str(tmp_path / "lightning.npy"))
    want, want_lpips = jax_load(pretrained_model=str(tmp_path / "without_unit.npy"))
    assert_trees_identical(got, _f32(want))
    assert_trees_identical(got, _f32(tiny_tree))
    assert_trees_identical(got_lpips, want_lpips)
    assert sorted(got_lpips) == sorted(k for k in ckpt["state_dict"] if k.startswith("losses."))

    d = _Ref(tiny_tree["params"]["da_model"])
    ref_dav2(d, np.random.default_rng(13))
    dav2_tree = dav2.convert_dav2(d.sd, encoder="vits")
    np.save(tmp_path / "dav2.npy", dav2_tree, allow_pickle=True)
    np.save(tmp_path / "dav2_without_unit.npy", _without(dav2_tree, {f"params/{p}" for p in DEAD_DAV2}), allow_pickle=True)
    with pytest.raises(KeyError, match="refinenet4/resConfUnit1"):
        jax_load(dav2_weights=str(tmp_path / "dav2.npy"))
    got, _ = port_load(dav2_weights=str(tmp_path / "dav2.npy"))
    want, _ = jax_load(dav2_weights=str(tmp_path / "dav2_without_unit.npy"))
    assert_trees_identical(got, _f32(want))
    assert_trees_identical(got["params"]["da_model"], _f32(tiny_tree["params"]["da_model"]))


def random_variables_like(tree, seed):
    rng = np.random.default_rng(seed)
    return {k: random_variables_like(v, seed + 1 + i) if isinstance(v, dict) else
            rng.normal(0.0, 0.05, np.shape(v)).astype(np.float32) + (1.0 if k in ("var", "scale") else 0.0)
            for i, (k, v) in enumerate(sorted(tree.items()))}
