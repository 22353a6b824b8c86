"""Path 3 of the port on the CPU: fit -> validate -> checkpoint -> resume ->
evaluate, each module held against its JAX counterpart where it has one.

  * metrics: compute_psnr / compute_ssim vs JAX on the same images (1e-5);
  * data: golden_scene_batch, synthetic_batch, _stack_examples, DataLoader
    equal to the JAX package's arrays bit for bit;
  * config: load_config field by field for every field both trees have;
  * initial parameters: every leaf's statistics against the Flax initialisers;
  * CheckpointManager: save / restore / intervals / max_to_keep;
  * Trainer.fit: an interrupted and resumed tiny run equals the uninterrupted
    one bit for bit (dropout on);
  * Evaluator: scores vs the JAX Evaluator with the weights carried across;
  * the reduced golden overfit gate of tests/test_training.py on the port.

Tiny widths throughout (d_feature 16, 32x32 images, two target views).
"""

import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modules import random_variables
from transplat_tpu import config as jax_config
from transplat_tpu.dataset import loader as jax_loader
from transplat_tpu.evaluation import metrics as jax_metrics
from transplat_tpu_torch import config as port_config
from transplat_tpu_torch.convert import load_jax_variables, to_jax_tree
from transplat_tpu_torch.dataset import loader as port_loader
from transplat_tpu_torch.evaluation import Evaluator, compute_psnr, compute_ssim
from transplat_tpu_torch.loss import LPIPS, LossCfg
from transplat_tpu_torch.model.encoder import EncoderTranSplat
from transplat_tpu_torch.training import (
    CheckpointManager, Trainer, create_train_state, make_lr_schedule, make_optimizer, make_train_step,
)

SHAPE = (32, 32)
TINY_ENCODER = dict(
    d_feature=16, num_depth_candidates=16, costvolume_unet_feat_dim=16, costvolume_unet_channel_mult=(1, 1),
    costvolume_unet_attn_res=(2,), depth_unet_feat_dim=8, depth_unet_attn_res=(4,),
    depth_unet_channel_mult=(1, 1, 1), dav2_encoder="vits", dav2_input_size=28,
    gaussian_adapter=dict(sh_degree=1), s2d_unet=False,
)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Tiny training steps are thousands of small ops. With PyTorch's default
    of one intra-op thread per core, several test workers on one machine
    contend for the cores and such a step takes seconds instead of tens of
    milliseconds; two threads are as fast alone and stay out of the way."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tiny_cfg(tmp_path, **trainer) -> port_config.RootCfg:
    return port_config.load_config(
        "re10k",
        encoder=TINY_ENCODER,
        dataset=dict(image_shape=SHAPE),
        loss=dict(lpips_weight=0.0),
        optimizer=dict(lr=1e-3, warm_up_steps=2, cosine_lr=False),
        trainer={**dict(max_steps=6, num_sanity_val_steps=1, val_check_interval=4), **trainer},
        checkpointing=dict(save_dir=str(tmp_path / "checkpoints"), every_n_train_steps=3),
        test=dict(output_path=str(tmp_path / "test"), eval_time_skip_steps=0),
    )


def golden(num_target=2):
    return port_loader.golden_scene_batch(image_shape=SHAPE, num_target=num_target)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _images(seed, n=3, h=24, w=20):
    rng = np.random.default_rng(seed)
    gt = rng.random((n, h, w, 3)).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.standard_normal(gt.shape).astype(np.float32), -0.2, 1.2).astype(np.float32)
    return gt, pred


def test_psnr_matches_jax():
    gt, pred = _images(0)
    ref = np.asarray(jax_metrics.compute_psnr(jnp.asarray(gt), jnp.asarray(pred)))
    got = compute_psnr(torch.from_numpy(gt), torch.from_numpy(pred)).numpy()
    assert got.shape == ref.shape == (3,)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-6)
    # leading batch dims, and identical images: the 1e-12 floor gives 120 dB
    got5 = compute_psnr(torch.from_numpy(gt[None]), torch.from_numpy(gt[None])).numpy()
    np.testing.assert_allclose(got5, np.full((1, 3), 120.0), atol=1e-3)


@pytest.mark.parametrize("seed,h,w", [(1, 24, 20), (2, 11, 11), (3, 32, 32)])
def test_ssim_matches_jax(seed, h, w):
    gt, pred = _images(seed, h=h, w=w)
    ref = np.asarray(jax_metrics.compute_ssim(jnp.asarray(gt), jnp.asarray(pred)))
    got = compute_ssim(torch.from_numpy(gt), torch.from_numpy(pred)).numpy()
    assert got.shape == ref.shape == (3,)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    same = compute_ssim(torch.from_numpy(gt), torch.from_numpy(gt)).numpy()
    np.testing.assert_allclose(same, 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _assert_same_batch(a, b):
    assert a["scene"] == b["scene"]
    for side in ("context", "target"):
        assert set(a[side]) == set(b[side])
        for k in a[side]:
            assert a[side][k].dtype == b[side][k].dtype, (side, k)
            np.testing.assert_array_equal(a[side][k], b[side][k], err_msg=f"{side}/{k}")


@pytest.mark.parametrize("kw", [dict(image_shape=(32, 32), num_target=2), dict(image_shape=(48, 40), num_context=3)])
def test_golden_scene_batch_is_the_jax_package_s(kw):
    _assert_same_batch(port_loader.golden_scene_batch(**kw), jax_loader.golden_scene_batch(**kw))


def test_stack_examples_and_dataloader_match_jax():
    def examples(n):
        for i in range(n):
            b = port_loader.synthetic_batch(i, image_shape=(8, 8))
            yield {
                "context": {k: v[0] for k, v in b["context"].items()},
                "target": {k: v[0] for k, v in b["target"].items()},
                "scene": f"scene_{i}",
            }

    ex = list(examples(5))
    _assert_same_batch(port_loader._stack_examples(ex[:2]), jax_loader._stack_examples(ex[:2]))
    for drop_last, count in ((True, 2), (False, 3)):
        got = list(port_loader.DataLoader(examples(5), 2, drop_last=drop_last))
        ref = list(jax_loader.DataLoader(examples(5), 2, drop_last=drop_last))
        assert len(got) == len(ref) == count
        for a, b in zip(got, ref):
            _assert_same_batch(a, b)
    assert got[0]["context"]["image"].shape == (2, 2, 8, 8, 3)
    dev = port_loader.batch_to_device(got[0], "cpu")
    assert set(dev) == {"context", "target"} and "index" not in dev["context"]
    assert dev["target"]["image"].dtype == torch.float32


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def _walk_common(a, b, path=""):
    """Yield (path, port value, JAX value) for every field both dataclass trees have."""
    names_b = {f.name for f in dataclasses.fields(b)}
    for f in dataclasses.fields(a):
        if f.name not in names_b:
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(va) and dataclasses.is_dataclass(vb):
            yield from _walk_common(va, vb, f"{path}{f.name}.")
        else:
            yield f"{path}{f.name}", va, vb


@pytest.mark.parametrize("experiment", ["re10k", "acid", "dtu"])
def test_load_config_matches_jax_field_by_field(experiment):
    port, ref = port_config.load_config(experiment), jax_config.load_config(experiment)
    seen = []
    for path, va, vb in _walk_common(port, ref):
        assert va == vb, (path, va, vb)
        seen.append(path)
    # every section is walked, and the known JAX-only fields are the only ones missing
    assert {p.split(".")[0] for p in seen} >= {
        "mode", "dataset", "view_sampler", "encoder", "decoder", "loss", "optimizer", "trainer", "checkpointing", "test",
    }
    assert len(seen) > 80
    port_names = lambda c: {f.name for f in dataclasses.fields(c)}  # noqa: E731
    assert port_names(ref.encoder) - port_names(port.encoder) == {"compute_dtype", "remat_unet", "remat_matching"}
    for section in ("dataset", "view_sampler", "loss", "optimizer", "checkpointing", "test"):
        assert port_names(getattr(ref, section)) == port_names(getattr(port, section)), section
    # The port's one field of its own: training steps that repeat their bits
    # on the card (the JAX package's do by construction).
    assert port_names(port.trainer) - port_names(ref.trainer) == {"deterministic_kernels"}
    assert port_names(ref.trainer) <= port_names(port.trainer) and port.trainer.deterministic_kernels is False
    assert not hasattr(port.decoder.rasterize, "capacity")  # the port's tile lists drop nothing


def test_load_config_overrides_and_yaml(tmp_path):
    over = dict(trainer=dict(max_steps=7, val_check_interval=0.5), encoder=dict(costvolume_unet_attn_res=[2]),
                checkpointing=dict(save_dir="x/y"))
    port, ref = port_config.load_config("re10k", **over), jax_config.load_config("re10k", **over)
    for path, va, vb in _walk_common(port, ref):
        assert va == vb, path
    assert port.trainer.max_steps == 7 and port.encoder.costvolume_unet_attn_res == (2,)
    assert port.encoder.d_feature == 128  # untouched fields stay
    yaml_file = tmp_path / "o.yaml"
    yaml_file.write_text("optimizer:\n  lr: 0.001\ndataset:\n  image_shape: [64, 64]\n")
    cfg = port_config.load_config("re10k", yaml_path=yaml_file, optimizer=dict(cosine_lr=False))
    assert cfg.optimizer.lr == 1e-3 and cfg.optimizer.cosine_lr is False and cfg.dataset.image_shape == (64, 64)
    from transplat_tpu_torch.inference import re10k_decoder_cfg, re10k_encoder_cfg

    assert re10k_encoder_cfg() == port_config.re10k_config().encoder
    assert re10k_decoder_cfg() == port_config.re10k_config().decoder
    with pytest.raises(KeyError):
        port_config.load_config("kitti")


# ---------------------------------------------------------------------------
# initial parameters
# ---------------------------------------------------------------------------


def test_initial_parameters_follow_the_flax_initialisers():
    """Each leaf of create_train_state(seed=...) against the same leaf of the
    JAX package's `EncoderTranSplat.init`: constants are equal; random leaves
    have zero mean, the same standard deviation (within 4 sigma of the
    estimator's spread for the leaf's size, two samples) and the same family
    (uniform leaves have max/std ~1.73, normal ones more)."""
    from transplat_tpu.model.adapter import GaussianAdapterCfg as JA
    from transplat_tpu.model.encoder import EncoderCfg as JE
    from transplat_tpu.model.encoder import EncoderTranSplat as JEnc

    kw = {**TINY_ENCODER, "d_feature": 32, "num_depth_candidates": 32, "costvolume_unet_feat_dim": 32, "depth_unet_feat_dim": 16}
    kw.pop("gaussian_adapter")
    cfg = port_config.load_config("re10k", encoder={**kw, "gaussian_adapter": dict(sh_degree=1)}).encoder
    ctx = golden()["context"]
    args = [jnp.asarray(ctx[k]) for k in ("image", "intrinsics", "extrinsics", "near", "far")]
    ref = jax.jit(lambda *a: JEnc(JE(**kw, gaussian_adapter=JA(sh_degree=1))).init(jax.random.PRNGKey(0), *a, train=False))(*args)
    state = create_train_state(cfg, make_optimizer(lambda s: 1e-3), None, device="cpu", seed=5)
    got = to_jax_tree(state.encoder)

    def flat(tree, prefix=()):
        for k, v in tree.items():
            yield from flat(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), np.asarray(v))]

    ref_leaves = dict(flat(jax.tree.map(np.asarray, dict(ref))))
    got_leaves = dict(flat(got))
    assert set(ref_leaves) == set(got_leaves)
    random_leaves = 0
    for path, b in ref_leaves.items():
        a = got_leaves[path]
        assert a.shape == b.shape, path
        if np.all(b == b.flat[0]):  # zeros, ones: equal
            np.testing.assert_array_equal(a, b, err_msg="/".join(path))
            continue
        if path[-1] == "cls_token":  # N(0, 1e-6): only its scale matters
            assert np.abs(a).max() < 1e-5
            continue
        random_leaves += 1
        n = a.size
        sa, sb = a.std(), b.std()
        assert abs(sa - sb) / sb < 4.0 * (1.0 / n) ** 0.5 + 0.02, ("/".join(path), sa, sb)
        assert abs(a.mean()) < 5.0 * sb / n**0.5, ("/".join(path), a.mean())
        if n >= 512:
            assert (np.abs(a).max() / sa < 1.9) == (np.abs(b).max() / sb < 1.9), ("/".join(path), "family")
    assert random_leaves > 150
    assert all(float(v.abs().max()) == 0.0 for v in state.opt_state.mu.values())


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------


def _tiny_state(tmp_path, seed):
    cfg = tiny_cfg(tmp_path)
    opt = make_optimizer(make_lr_schedule(1e-3, 10, cosine=False, warm_up_steps=1), 0.5)
    state = create_train_state(cfg.encoder, opt, None, device="cpu", seed=seed)
    return cfg, opt, state


def test_checkpoint_save_restore_roundtrip(tmp_path):
    cfg, opt, state = _tiny_state(tmp_path, seed=1)
    step = make_train_step(cfg.encoder, cfg.loss, cfg.decoder, opt, SHAPE)
    batch = port_loader.batch_to_device(golden(), "cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):  # moves parameters, BatchNorm statistics and both Adam moments
        state, _ = step(state, batch, gen)
    mgr = CheckpointManager(tmp_path / "ck", every_n_steps=2)
    assert mgr.latest_step() is None and mgr.restore(state) is None  # empty directory
    assert mgr.maybe_save(1, state) is False and mgr.maybe_save(2, state) is True
    assert mgr.latest_step() == 2 and [p.name for p in (tmp_path / "ck").iterdir()] == ["step_00000002.pt"]

    _, _, fresh = _tiny_state(tmp_path, seed=2)
    assert not torch.equal(fresh.encoder.backbone.backbone.conv1.weight, state.encoder.backbone.backbone.conv1.weight)
    restored = CheckpointManager(tmp_path / "ck").restore(fresh)
    assert restored is fresh and restored.step == 2 and restored.opt_state.count == 2
    want, have = state.encoder.state_dict(), restored.encoder.state_dict()
    assert set(want) == set(have) and any("running_var" in k for k in want)
    for k in want:
        assert torch.equal(want[k], have[k]), k
    assert set(restored.opt_state.mu) == set(restored.trainable())
    for k in state.opt_state.mu:
        assert torch.equal(state.opt_state.mu[k], restored.opt_state.mu[k]), k
        assert torch.equal(state.opt_state.nu[k], restored.opt_state.nu[k]), k
    assert any(float(v.abs().max()) > 0 for v in restored.opt_state.nu.values())
    # the restored state trains on exactly as the original
    a, _ = step(state, batch, torch.Generator().manual_seed(7))
    b, _ = step(restored, batch, torch.Generator().manual_seed(7))
    for (k, p), q in zip(a.trainable().items(), b.trainable().values()):
        assert torch.equal(p, q), k


def test_checkpoint_intervals_max_to_keep_and_repeated_save(tmp_path):
    _, _, state = _tiny_state(tmp_path, seed=3)
    mgr = CheckpointManager(tmp_path / "ck", every_n_steps=2, max_to_keep=2)
    saved = [s for s in range(1, 8) if mgr.maybe_save(s, state)]
    assert saved == [2, 4, 6]
    assert mgr.all_steps() == [4, 6]  # the oldest went
    mgr.save(7, state)  # off the interval: forced
    assert mgr.all_steps() == [6, 7] and mgr.latest_step() == 7
    before = (tmp_path / "ck" / "step_00000007.pt").stat().st_mtime_ns
    mgr.save(7, state)  # a second save at the latest step returns quietly
    assert (tmp_path / "ck" / "step_00000007.pt").stat().st_mtime_ns == before
    assert mgr.maybe_save(6, state) is False  # already there
    mgr.wait()
    assert not [p for p in (tmp_path / "ck").iterdir() if "tmp" in p.name]
    state.step = 0
    assert mgr.restore(state, step=6).step == 6
    payload = torch.load(tmp_path / "ck" / "step_00000007.pt", weights_only=True)
    assert set(payload) == {"step", "encoder", "opt_state"} and set(payload["opt_state"]) == {"count", "mu", "nu"}


def test_port_checkpoint_feeds_the_jax_encoder(tmp_path):
    """A port checkpoint, restored and passed through to_jax_tree, gives the
    JAX encoder the port's Gaussians (1e-3 absolute + relative, the bound of
    tests/test_torch_encoder.py)."""
    from transplat_tpu.model.adapter import GaussianAdapterCfg as JA
    from transplat_tpu.model.encoder import EncoderCfg as JE
    from transplat_tpu.model.encoder import EncoderTranSplat as JEnc

    cfg, _, state = _tiny_state(tmp_path, seed=4)
    with torch.no_grad():  # an untrained U-Net is the identity and DAv2's random head is flat: stir both
        for p in state.encoder.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
        state.encoder.depth_predictor.to_disparity_2.weight[0] *= 0.01
    CheckpointManager(tmp_path / "ck").save(5, state)
    _, _, fresh = _tiny_state(tmp_path, seed=9)
    restored = CheckpointManager(tmp_path / "ck").restore(fresh)
    variables = to_jax_tree(restored.encoder)
    kw = {k: v for k, v in TINY_ENCODER.items() if k != "gaussian_adapter"}
    ctx = [golden()["context"][k] for k in ("image", "intrinsics", "extrinsics", "near", "far")]
    g_j = jax.jit(JEnc(JE(**kw, gaussian_adapter=JA(sh_degree=1))).apply)(variables, *(jnp.asarray(a) for a in ctx))
    with torch.no_grad():
        g_t = state.encoder(*(torch.from_numpy(a) for a in ctx))
    for name in ("means", "covariances", "harmonics", "opacities"):
        np.testing.assert_allclose(
            getattr(g_t, name).numpy(), np.asarray(getattr(g_j, name)), atol=1e-3, rtol=1e-3, err_msg=name
        )


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


def _batches():
    """Two alternating scenes, for ever."""
    scenes = [golden(), port_loader.synthetic_batch(3, image_shape=SHAPE, num_target=2)]
    i = 0
    while True:
        yield scenes[i % 2]
        i += 1


def _skip(it, n):
    for _ in range(n):
        next(it)
    return it


def test_trainer_fit_resumes_to_the_same_parameters(tmp_path):
    """6 steps with a checkpoint at 3, dropout on; then a fresh Trainer on a
    copy of the step-3 checkpoint, fed the batches from step 3 on, reaches
    bit-identical parameters, BatchNorm statistics and Adam moments at 6. The
    JAX Trainer restarts its dropout key stream at PRNGKey(seed + 1) after a
    resume (transplat_tpu/training/trainer.py:370), so its resumed run draws
    other masks than the uninterrupted one; the port seeds every step's masks
    from (seed + 1, step) and so reproduces them."""
    logs = []
    cfg_a = tiny_cfg(tmp_path / "a")
    trainer = Trainer(cfg_a, log_fn=logs.append, device="cpu", log_every=2)
    full = trainer.fit(_batches(), max_steps=6)
    assert full.step == 6 and trainer.global_step == 6
    ck_a = tmp_path / "a" / "checkpoints"
    assert sorted(p.name for p in ck_a.iterdir()) == ["config.json", "step_00000003.pt", "step_00000006.pt"]
    snapshot = json.loads((ck_a / "config.json").read_text())
    assert snapshot["trainer"]["max_steps"] == 6 and snapshot["encoder"]["d_feature"] == 16
    records = [json.loads(line) for line in (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "loss" in r] == [2, 4, 6]
    assert [r["step"] for r in records if "val_psnr" in r] == [4]
    assert {"loss", "mse", "psnr", "grad_norm", "lr", "render_overflow", "s_per_it"} <= set(records[0])
    # the sanity validation's and the step-4 validation's media, beside metrics.jsonl
    assert sorted(p.name for p in (tmp_path / "a" / "local").iterdir()) == sorted(
        f"{kind}_{step:08d}.{ext}" for step in (0, 4)
        for kind, ext in (("projections", "png"), ("validation", "png"), ("wobble", "mp4")))
    assert logs[0].startswith("sanity validation: psnr=") and sum("sanity" in m for m in logs) == 1
    assert any(m.startswith("step 6: loss=") for m in logs)

    cfg_b = tiny_cfg(tmp_path / "b")
    ck_b = tmp_path / "b" / "checkpoints"
    ck_b.mkdir(parents=True)
    (ck_b / "step_00000003.pt").write_bytes((ck_a / "step_00000003.pt").read_bytes())
    logs_b = []
    resumed_trainer = Trainer(cfg_b, log_fn=logs_b.append, device="cpu", log_every=2)
    resumed = resumed_trainer.fit(_skip(_batches(), 3), max_steps=6)
    assert "resumed from step 3" in logs_b and resumed.step == 6
    want, have = full.encoder.state_dict(), resumed.encoder.state_dict()
    for k in want:
        assert torch.equal(want[k], have[k]), k
    for k in full.opt_state.mu:
        assert torch.equal(full.opt_state.mu[k], resumed.opt_state.mu[k]), k
        assert torch.equal(full.opt_state.nu[k], resumed.opt_state.nu[k]), k
    assert full.opt_state.count == resumed.opt_state.count == 6
    # dropout was on: another seed gives other parameters after the same steps
    other = Trainer(tiny_cfg(tmp_path / "c", seed=5, val_save_media=False), log_fn=lambda m: None,
                    device="cpu").fit(_batches(), max_steps=2)
    again = Trainer(tiny_cfg(tmp_path / "d", seed=5, val_save_media=False), log_fn=lambda m: None,
                    device="cpu").fit(_batches(), max_steps=2)
    key = "depth_predictor.uv_matcher.fine_0.ffn.fc2.weight"
    assert torch.equal(other.encoder.state_dict()[key], again.encoder.state_dict()[key])

    # resuming at max_steps takes no step and saves nothing new
    done = Trainer(cfg_a, log_fn=lambda m: None, device="cpu").fit(_batches(), max_steps=6)
    assert done.step == 6 and sorted(p.name for p in ck_a.iterdir())[-1] == "step_00000006.pt"


def test_trainer_warm_start_validate_and_refusals(tmp_path):
    cfg_a = tiny_cfg(tmp_path / "a", num_sanity_val_steps=0, val_save_media=False)  # media: test_torch_validation_media.py
    first = Trainer(cfg_a, log_fn=lambda m: None, device="cpu").fit(_batches(), max_steps=1)
    # a fresh run directory warm-starts from checkpointing.load
    cfg_b = port_config._apply_overrides(
        tiny_cfg(tmp_path / "b", num_sanity_val_steps=0, val_save_media=False),
        dict(checkpointing=dict(load=cfg_a.checkpointing.save_dir))
    )
    logs = []
    trainer = Trainer(cfg_b, log_fn=logs.append, device="cpu")
    warm = trainer.fit(_batches(), max_steps=1)  # already at step 1: no step taken
    assert "resumed from step 1" in logs and warm.step == 1
    key = "backbone.backbone.conv1.weight"
    assert torch.equal(first.encoder.state_dict()[key], warm.encoder.state_dict()[key])
    val = trainer.validate(warm, golden())
    assert set(val) == {"val_psnr"} and np.isfinite(val["val_psnr"]) and 3.0 < val["val_psnr"] < 40.0
    assert [p.name for p in trainer.media_dir.iterdir()] == ["validation_00000001.png"]  # val_save_media off: the grid
    assert not warm.encoder.training  # validation and the step leave the encoder in eval mode
    with pytest.raises(FileNotFoundError, match="no training chunks"):  # fit(None) reads chunks: none here
        trainer.fit(None)
    # a weight file that is not there fails at construction, naming it (weight files load since the port of
    # training/pretrained.py; tests/test_torch_pretrained.py loads them)
    with pytest.raises(FileNotFoundError, match="w.npy"):
        Trainer(port_config._apply_overrides(cfg_a, dict(checkpointing=dict(lpips_weights="w.npy"))), device="cpu")
    # a data iterator that ends stops the run and still saves
    cfg_c = tiny_cfg(tmp_path / "c", num_sanity_val_steps=0, val_save_media=False)
    short = Trainer(cfg_c, log_fn=lambda m: None, device="cpu").fit(iter([golden(), golden()]), max_steps=6)
    assert short.step == 2 and CheckpointManager(cfg_c.checkpointing.save_dir).latest_step() == 2


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def evaluator_pair(tmp_path_factory):
    from transplat_tpu.evaluation.evaluator import Evaluator as JEvaluator
    from transplat_tpu.loss.vgg import LPIPS as JLPIPS
    from transplat_tpu.model.encoder import EncoderTranSplat as JEnc

    tmp = tmp_path_factory.mktemp("eval")
    jkw = {k: v for k, v in TINY_ENCODER.items()}
    jcfg = jax_config.load_config(
        "re10k", encoder=jkw, dataset=dict(image_shape=SHAPE),
        decoder=dict(rasterize=dict(mode="tiled", binning="fast", capacity=4096, chunk=128)),
        test=dict(output_path=str(tmp / "jax"), eval_time_skip_steps=0),
    )
    batch = golden()
    ctx = [batch["context"][k] for k in ("image", "intrinsics", "extrinsics", "near", "far")]
    variables = random_variables(JEnc(jcfg.encoder), *ctx, seed=21)
    variables["params"]["depth_predictor"]["to_disparity_2"]["kernel"][..., 0] *= 0.01  # depths off the 1/far clip
    zeros = np.zeros((1, *SHAPE, 3), np.float32)
    lpips_params = random_variables(JLPIPS(), zeros, zeros, seed=5)["params"]
    cfg = tiny_cfg(tmp)
    encoder = load_jax_variables(EncoderTranSplat(cfg.encoder, device="cpu"), variables)
    lpips = load_jax_variables(LPIPS(device="cpu"), {"params": lpips_params})
    return cfg, encoder, lpips, JEvaluator(jcfg, variables, lpips_params), batch


def test_evaluator_scores_match_jax(evaluator_pair):
    cfg, encoder, lpips, jax_evaluator, batch = evaluator_pair
    ref, ref_color = jax_evaluator.evaluate_batch(batch)
    got, color = Evaluator(cfg, encoder, lpips, device="cpu").evaluate_batch(batch)
    assert set(got) == set(ref) == {"psnr", "ssim", "lpips", "render_overflow"}
    assert color.shape == ref_color.shape == (1, 2, *SHAPE, 3) and color.dtype == np.float32
    # The image is a step function of the Gaussians (integer cutoff radius,
    # 1/255 alpha floor), so a few pixels differ by up to ~0.03 end to end:
    # PSNR within 0.05 dB, SSIM within 1e-3, LPIPS within 2% (random weights).
    assert abs(got["psnr"] - ref["psnr"]) < 0.05, (got["psnr"], ref["psnr"])
    assert abs(got["ssim"] - ref["ssim"]) < 1e-3, (got["ssim"], ref["ssim"])
    assert np.isfinite(got["lpips"]) and abs(got["lpips"] - ref["lpips"]) < 0.02 * abs(ref["lpips"]) + 1e-4
    assert got["render_overflow"] == ref["render_overflow"] == 0
    assert all(isinstance(v, (int, float)) for v in got.values())


def test_evaluator_without_lpips_run_and_finalize(evaluator_pair, capsys, tmp_path):
    cfg, encoder, _, jax_evaluator, batch = evaluator_pair
    ev = Evaluator(cfg, encoder, device="cpu")
    scores, _ = ev.evaluate_batch(batch)
    assert set(scores) == {"psnr", "ssim", "render_overflow"}  # no LPIPS module, no LPIPS score
    other = {**port_loader.synthetic_batch(1, image_shape=SHAPE, num_target=2), "scene": ["second"]}
    ev = Evaluator(cfg, encoder, device="cpu")
    result = ev.run([batch, other, batch], max_scenes=2)
    assert list(result) == ["golden_planes", "second"]
    out = cfg.test.output_path
    per_scene = json.loads(open(f"{out}/scores_per_scene.json").read())
    avg = json.loads(open(f"{out}/scores_all_avg.json").read())
    bench = json.loads(open(f"{out}/benchmark.json").read())
    assert per_scene == result and set(avg) == {"psnr", "ssim", "render_overflow"}
    assert avg["psnr"] == pytest.approx(np.mean([s["psnr"] for s in result.values()]))
    # the JAX Evaluator's files and keys
    jax_evaluator.scores = {"golden_planes": jax_evaluator.evaluate_batch(batch)[0]}
    jout = jax_evaluator.cfg.test.output_path
    os.makedirs(jout, exist_ok=True)  # the JAX Evaluator makes it in run()
    jax_evaluator.finalize(Path(jout))
    assert sorted(os.listdir(jout)) == sorted(os.listdir(out)) == ["benchmark.json", "scores_all_avg.json", "scores_per_scene.json"]
    jbench = json.loads(open(f"{jout}/benchmark.json").read())
    assert set(bench) == set(jbench) == {"summary", "raw"}
    assert set(bench["summary"]) == {"encoder", "decoder"}
    assert bench["summary"]["encoder"].keys() == jbench["summary"]["encoder"].keys() == {"count", "total_s", "mean_ms"}
    assert bench["summary"]["encoder"]["count"] == 2 and bench["summary"]["decoder"]["count"] == 4  # 2 views per scene
    assert "averaged scores:" in capsys.readouterr().out
    with pytest.raises(ValueError, match="evaluation_index is not set"):
        ev.make_dataset()
    index = tmp_path / "index.json"
    index.write_text(json.dumps({"golden_planes": {"context": [0, 1], "target": [0]}}))
    indexed = port_config._apply_overrides(cfg, dict(test=dict(evaluation_index=str(index))))
    dataset = Evaluator(indexed, encoder, device="cpu").make_dataset()  # the test split through the index
    assert dataset.stage == "test" and dataset.view_sampler.scenes() == ["golden_planes"]
    # the artifact options are accepted (tests/test_torch_evaluation_artifacts.py runs them); stage_timing
    # puts the staged encoder in place
    staged = Evaluator(port_config._apply_overrides(cfg, dict(test=dict(save_ply=True, stage_timing=True))), encoder,
                       device="cpu")
    assert staged._staged is not None and staged._staged.encoder is encoder and ev._staged is None


def test_benchmarker_times_and_summarises(tmp_path):
    from transplat_tpu_torch.utils.benchmarker import Benchmarker

    b = Benchmarker(device="cpu")
    for _ in range(3):
        with b.time("encoder"):
            pass
    with b.time("decoder", num_calls=4):
        pass
    with b.memory("encoder"):
        pass
    s = b.summarize(skip_first=1)
    assert s["encoder"]["count"] == 2 and s["decoder"]["count"] == 3
    assert b.summarize(skip_first=10)["encoder"]["count"] == 3  # fewer calls than skipped: all are used
    assert b.memory_stats == {"encoder": {}}  # the CPU has no allocator statistics
    b.dump(tmp_path / "x" / "benchmark.json")
    assert set(json.loads((tmp_path / "x" / "benchmark.json").read_text())["raw"]) == {"encoder", "decoder"}
    b.clear_history()
    assert b.summarize() == {}


# ---------------------------------------------------------------------------
# the reduced golden overfit gate
# ---------------------------------------------------------------------------


def test_golden_overfit_cpu():
    """The reduced tier of the golden-scene gate (overfit_golden.py), as
    tests/test_training.py::TestGoldenOverfit runs it on the JAX package:
    tiny encoder, 32x32, constant lr 2e-3 after one warm-up step, no LPIPS,
    one dropout seed, 100 steps; PSNR > 13.8 dB and a gain of more than 1 dB.
    (Measured: 10.5 -> 23.1 dB, ~30 s on 4 CPU threads.)"""
    cfg = tiny_cfg(Path("unused"))
    batch = port_loader.batch_to_device(golden(), "cpu")
    opt = make_optimizer(make_lr_schedule(2e-3, 200, cosine=False, warm_up_steps=1), grad_clip=0.5)
    state = create_train_state(cfg.encoder, opt, None, device="cpu", seed=0)
    step = make_train_step(cfg.encoder, LossCfg(lpips_weight=0.0), cfg.decoder, opt, SHAPE)
    gen = torch.Generator()
    first_psnr, psnr = None, 0.0
    for _ in range(100):
        state, metrics = step(state, batch, gen.manual_seed(1))
        psnr = float(metrics["psnr"])
        first_psnr = psnr if first_psnr is None else first_psnr
        assert int(metrics["render_overflow"]) == 0
    assert np.isfinite(psnr)
    assert psnr > 13.8, f"final psnr {psnr} (start {first_psnr})"
    assert psnr - first_psnr > 1.0, f"no improvement: {first_psnr} -> {psnr}"


def test_overfit_golden_script_gate_and_record(tmp_path, capsys):
    from transplat_tpu_torch import overfit_golden

    out = tmp_path / "o" / "record.json"
    # The script's plumbing at a narrow width, 2 steps: the full re10k width is for the card.
    cfg = tiny_cfg(tmp_path)
    args = ["--steps", "2", "--size", "32", "--device", "cpu", "--out", str(out)]
    rc = overfit_golden.main([*args, "--min-psnr", "99"], cfg=cfg)
    assert rc == 1 and "FAIL: median-of-last-5" in capsys.readouterr().out
    record = json.loads(out.read_text())
    assert set(record) == {
        "steps", "size", "cosine", "device", "final_psnr", "gate_psnr_median_last5", "wall_s", "curve", "passed",
    }
    assert [c["step"] for c in record["curve"]] == [0, 1] and record["passed"] is False and record["cosine"] is True
    assert set(record["curve"][0]) == {"step", "psnr", "loss", "overflow"}
    assert overfit_golden.main([*args, "--min-psnr", "1", "--no-cosine"], cfg=cfg) == 0
