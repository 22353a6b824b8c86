"""Weight files, port vs JAX package: the .npy trees of
`checkpointing.pretrained_model` / `dav2_weights` (training/pretrained.py)
and converted LPIPS weights (loss/vgg.py `load_lpips_weights`).

The same seeded tree goes into both packages. The port merges in the JAX
layout (convert.to_jax_tree -> merge_tree -> convert.load_jax_variables),
so its loaded tensors, laid out again as a JAX tree, must equal the JAX
package's merged variables bit for bit (float32), and leaves the tree does
not name keep their values bit for bit. The encoder run on the loaded
weights is held to JAX within test_torch_encoder's tolerances (1e-3), LPIPS
with the same loaded weights within 1e-5 relative. Tiny encoder widths,
16x16 and 64x64 images.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import seeded_lpips_state as lpips_state_dict
from test_torch_encoder import _tiny_cfgs
from test_torch_modules import random_variables
from transplat_tpu.config import CheckpointingCfg as JCkpt
from transplat_tpu.training import pretrained as jax_pretrained
from transplat_tpu_torch.config import CheckpointingCfg
from transplat_tpu_torch.convert import load_jax_variables, to_jax_tree
from transplat_tpu_torch.loss.vgg import LPIPS, init_lpips, load_lpips_weights
from transplat_tpu_torch.training import pretrained
from transplat_tpu_torch.training.schedule import make_lr_schedule
from transplat_tpu_torch.training.step import create_train_state, make_optimizer

CTX_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


@pytest.fixture(scope="module")
def base():
    """JAX variables of the tiny encoder (seeded), the port encoder loaded
    from them, and a 64x64 batch."""
    from transplat_tpu.model.encoder import EncoderTranSplat as JEnc
    from transplat_tpu_torch.dataset import synthetic_batch
    from transplat_tpu_torch.model.encoder import EncoderTranSplat as TEnc

    jcfg, tcfg = _tiny_cfgs()
    batch = synthetic_batch(0, image_shape=(64, 64), num_target=1)
    ctx = [batch["context"][k] for k in CTX_KEYS]
    jm = JEnc(jcfg)
    variables = random_variables(jm, *ctx, seed=31)
    variables["params"]["depth_predictor"]["to_disparity_2"]["kernel"][..., 0] *= 0.01  # depths off the 1/far clip

    def port():
        return load_jax_variables(TEnc(tcfg, device="cpu"), variables)

    return jm, variables, port, ctx


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + rng.normal(0, 0.01, np.shape(x))).astype(np.float32), tree)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32), err_msg=k)


def _both_load(port_encoder, variables, **files):
    """Load `files` into the port encoder and into the JAX variables; return
    (the port's tree, the JAX merged variables, the JAX lpips_state)."""
    lpips_state = pretrained.load_pretrained_variables(port_encoder, CheckpointingCfg(**files))
    merged, jax_lpips = jax_pretrained.load_pretrained_variables(copy.deepcopy(variables), JCkpt(**files))
    return to_jax_tree(port_encoder), jax.tree.map(np.asarray, merged), lpips_state, jax_lpips


# ---------------------------------------------------------------------------
# merge_tree: the same result and the same errors as the JAX package's
# ---------------------------------------------------------------------------


def test_merge_tree_partial_merge_casts_and_keeps_untouched_leaves():
    base = {"a": {"x": np.zeros(3, np.float32), "y": np.ones(2, np.float32)}, "b": np.zeros(1, np.float32)}
    out = pretrained.merge_tree(base, {"a": {"x": np.full(3, 7.0, np.float64)}})
    ref = jax_pretrained.merge_tree(base, {"a": {"x": np.full(3, 7.0, np.float64)}})
    assert out["a"]["x"].dtype == np.float32  # the model's dtype
    np.testing.assert_array_equal(out["a"]["x"], 7.0)
    assert out["a"]["y"] is base["a"]["y"] and out["b"] is base["b"]
    _assert_trees_equal(out, ref)


@pytest.mark.parametrize(
    "override, error, words",
    [
        ({"a": {"nope": np.zeros(2)}}, KeyError, "pretrained key 'a/nope' not present in model tree"),
        ({"a": {"x": np.zeros(4)}}, ValueError, "shape mismatch at 'a/x': model (3,) vs checkpoint (4,)"),
        ({"b": {"c": np.zeros(1)}}, ValueError, "'b' is a subtree in the checkpoint but a leaf in the model"),
    ],
    ids=["unknown_key", "shape_mismatch", "subtree_over_leaf"],
)
def test_merge_tree_errors_match_jax(override, error, words):
    base = {"a": {"x": np.zeros(3, np.float32)}, "b": np.zeros(1, np.float32)}
    with pytest.raises(error) as ours:
        pretrained.merge_tree(base, override)
    with pytest.raises(error) as theirs:
        jax_pretrained.merge_tree(base, override)
    assert words in str(ours.value)
    assert str(ours.value) == str(theirs.value)  # the same JAX-style path in both packages


# ---------------------------------------------------------------------------
# the three tree shapes through config
# ---------------------------------------------------------------------------


def test_encoder_level_tree_equals_jax_bit_for_bit(base, tmp_path):
    jm, variables, port, _ = base
    encoder = port()
    before = {k: v.clone() for k, v in encoder.state_dict().items()}
    # A Lightning-shaped tree: one subtree of params and its BatchNorm statistics.
    tree = {
        "params": {"depth_predictor": _perturb(variables["params"]["depth_predictor"], 1)},
        "batch_stats": {"depth_predictor": _perturb(variables["batch_stats"]["depth_predictor"], 2)},
    }
    path = tmp_path / "lightning.npy"
    np.save(path, tree, allow_pickle=True)
    got, want, lpips_state, jax_lpips = _both_load(encoder, variables, pretrained_model=str(path))
    assert lpips_state is None and jax_lpips is None
    _assert_trees_equal(got, want)
    after = encoder.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert moved and all(k.startswith("depth_predictor.") for k in moved)
    assert any("running_mean" in k for k in moved)  # batch_stats land in the running statistics
    assert torch.equal(before["backbone.backbone.conv1.weight"], after["backbone.backbone.conv1.weight"])


def test_unimatch_and_dav2_trees_nest_like_jax(base, tmp_path):
    jm, variables, port, _ = base
    encoder = port()
    before = {k: v.clone() for k, v in encoder.state_dict().items()}
    backbone = variables["params"]["backbone"]
    uni = {
        "params": {"backbone": _perturb(backbone["backbone"], 3), "transformer": _perturb(backbone["transformer"], 4)},
        "batch_stats": {},
    }
    dav2 = {"params": _perturb(variables["params"]["da_model"], 5), "batch_stats": {}}
    np.save(tmp_path / "unimatch.npy", uni, allow_pickle=True)
    np.save(tmp_path / "dav2.npy", dav2, allow_pickle=True)
    got, want, lpips_state, _ = _both_load(encoder, variables, pretrained_model=str(tmp_path / "unimatch.npy"),
                                           dav2_weights=str(tmp_path / "dav2.npy"))
    assert lpips_state is None
    _assert_trees_equal(got, want)
    after = encoder.state_dict()
    # cam_param_encoder is not in the UniMatch tree and the depth predictor in neither: untouched.
    for k in before:
        if k.startswith(("backbone.cam_param_encoder.", "depth_predictor.")):
            assert torch.equal(before[k], after[k]), k
    assert not torch.equal(before["da_model.depth_head.output_conv1.weight"],
                           after["da_model.depth_head.output_conv1.weight"])


def test_tree_errors_name_the_jax_path(base, tmp_path):
    _, variables, port, _ = base
    bad_shape = {"params": {"depth_predictor": {"corr_conv_in": {"kernel": np.zeros((3, 3, 1, 1), np.float32)}}}}
    np.save(tmp_path / "shape.npy", bad_shape, allow_pickle=True)
    with pytest.raises(ValueError, match="shape mismatch at 'depth_predictor/corr_conv_in/kernel'"):
        pretrained.load_pretrained_variables(port(), CheckpointingCfg(pretrained_model=str(tmp_path / "shape.npy")))
    # DAv2 has no BatchNorm statistics: a DAv2 tree that carries some is refused, in both packages.
    dav2 = {"params": variables["params"]["da_model"], "batch_stats": {"x": np.zeros(1, np.float32)}}
    np.save(tmp_path / "dav2.npy", dav2, allow_pickle=True)
    with pytest.raises(KeyError, match="'da_model' not present in model tree"):
        pretrained.load_pretrained_variables(port(), CheckpointingCfg(dav2_weights=str(tmp_path / "dav2.npy")))
    with pytest.raises(KeyError, match="'da_model' not present in model tree"):
        jax_pretrained.load_pretrained_variables(copy.deepcopy(variables), JCkpt(dav2_weights=str(tmp_path / "dav2.npy")))


def test_encoder_on_loaded_weights_matches_jax(base, tmp_path):
    jm, variables, port, ctx = base
    tree = {"params": {"depth_predictor": _perturb(variables["params"]["depth_predictor"], 6)}, "batch_stats": {}}
    np.save(tmp_path / "tree.npy", tree, allow_pickle=True)
    # The weights come from the file only: the port starts from other parameters.
    encoder = port()
    gen = torch.Generator().manual_seed(99)
    with torch.no_grad():
        for p in encoder.depth_predictor.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    pretrained.load_pretrained_variables(encoder, CheckpointingCfg(pretrained_model=str(tmp_path / "tree.npy")))
    merged, _ = jax_pretrained.load_pretrained_variables(copy.deepcopy(variables), JCkpt(pretrained_model=str(tmp_path / "tree.npy")))
    with torch.no_grad():
        g_t = encoder(*(torch.from_numpy(a) for a in ctx))
    g_j = jax.jit(jm.apply)(merged, *(jnp.asarray(a) for a in ctx))
    for name in ("means", "covariances", "harmonics", "opacities"):
        np.testing.assert_allclose(getattr(g_t, name).numpy(), np.asarray(getattr(g_j, name)), atol=1e-3, rtol=1e-3,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# LPIPS weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("naming, prefix", [("torchvision", ""), ("lpips", "losses.0.lpips.")])
def test_load_lpips_weights_matches_jax(naming, prefix):
    from transplat_tpu.loss.vgg import LPIPS as JLPIPS
    from transplat_tpu.training.step import init_lpips_params

    state = lpips_state_dict(naming, prefix, seed=1)
    ours = load_lpips_weights(LPIPS(device="cpu"), state)
    params = init_lpips_params((32, 32), state)
    # The loaded port module is the JAX parameters, laid out as JAX lays them.
    _assert_trees_equal(to_jax_tree(ours)["params"], jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    with torch.no_grad():
        got = ours(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(JLPIPS().apply({"params": params}, jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_load_lpips_weights_is_strict():
    state = lpips_state_dict("torchvision")
    missing_conv = {k: v for k, v in state.items() if not k.startswith("net.features.28.")}
    with pytest.raises(ValueError, match="expected 13 VGG conv weights, matched 12"):
        load_lpips_weights(LPIPS(device="cpu"), missing_conv)
    missing_head = {k: v for k, v in state.items() if not k.startswith("lin4.")}
    with pytest.raises(ValueError, match="expected 5 LPIPS linear heads, matched 4"):
        load_lpips_weights(LPIPS(device="cpu"), missing_head)
    lpips = LPIPS(device="cpu", seed=3)
    before = lpips.vgg.conv0.weight.clone()
    with pytest.raises(ValueError):
        load_lpips_weights(lpips, missing_head)
    assert torch.equal(lpips.vgg.conv0.weight, before)  # a refused load changes nothing
    assert init_lpips(None, "cpu") is None  # no weights: no LPIPS module


def test_lightning_embedded_lpips_becomes_the_state_lpips(base, tmp_path):
    _, variables, _, _ = base
    _, tcfg = _tiny_cfgs()
    lpips_state = lpips_state_dict("lpips", "losses.0.lpips.", seed=4)
    tree = {"params": {"depth_predictor": variables["params"]["depth_predictor"]}, "batch_stats": {},
            "lpips_state": lpips_state}
    np.save(tmp_path / "lightning.npy", tree, allow_pickle=True)
    optimizer = make_optimizer(make_lr_schedule(2e-4, 100))
    state = create_train_state(tcfg, optimizer, None, device="cpu", seed=0,
                               ckpt_cfg=CheckpointingCfg(pretrained_model=str(tmp_path / "lightning.npy")))
    assert state.lpips is not None and not state.lpips.vgg.conv0.weight.requires_grad
    np.testing.assert_array_equal(state.lpips.vgg.conv0.weight.numpy(), lpips_state["losses.0.lpips.net.slice1.0.weight"])
    np.testing.assert_array_equal(state.lpips.lin0.numpy(), lpips_state["losses.0.lpips.lin0.model.1.weight"].reshape(-1))
    np.testing.assert_array_equal(state.encoder.depth_predictor.corr_conv_in.bias.detach().numpy(),
                                  variables["params"]["depth_predictor"]["corr_conv_in"]["bias"])
    # A given LPIPS wins over the embedded one; the Adam moments cover the loaded parameters.
    given = LPIPS(device="cpu", seed=7)
    state2 = create_train_state(tcfg, optimizer, given, device="cpu", seed=0,
                                ckpt_cfg=CheckpointingCfg(pretrained_model=str(tmp_path / "lightning.npy")))
    assert state2.lpips is given and set(state2.opt_state.mu) == set(state2.trainable())


def test_trainer_loads_lpips_weights_and_pretrained_tree(base, tmp_path):
    from test_torch_fit_eval import tiny_cfg
    from transplat_tpu_torch import config as port_config
    from transplat_tpu_torch.training import Trainer

    _, variables, _, _ = base
    np.save(tmp_path / "lpips.npy", lpips_state_dict("torchvision", seed=5), allow_pickle=True)
    np.save(tmp_path / "tree.npy", {"params": {"depth_predictor": variables["params"]["depth_predictor"]}},
            allow_pickle=True)
    cfg = port_config._apply_overrides(tiny_cfg(tmp_path / "run"), dict(checkpointing=dict(
        lpips_weights=str(tmp_path / "lpips.npy"), pretrained_model=str(tmp_path / "tree.npy"))))
    logs = []
    trainer = Trainer(cfg, log_fn=logs.append, device="cpu")
    assert trainer.lpips is not None and f"loaded LPIPS weights from {tmp_path / 'lpips.npy'}" in logs
    state = create_train_state(cfg.encoder, trainer.optimizer, trainer.lpips, device="cpu",
                               seed=cfg.trainer.seed, ckpt_cfg=cfg.checkpointing)
    np.testing.assert_array_equal(state.encoder.depth_predictor.corr_conv_in.bias.detach().numpy(),
                                  variables["params"]["depth_predictor"]["corr_conv_in"]["bias"])
