"""The encoder's compute_dtype and gradient checkpointing (remat_unet,
remat_matching) in the port vs the JAX package, on the CPU at the tiny
configuration of __graft_entry__.py (64x64, s2d_unet off).

The JAX reference at bfloat16 is compiled with XLA's excess precision off
(`strict_jit`): by default XLA's CPU backend drops a bfloat16 rounding that
is followed at once by a cast back to float32 (a GroupNorm's input, a
head's output, the LPIPS taps), so that the rounding points depend on XLA's
fusions. Strict, each value is rounded where the Flax program says, which
is what the port's explicit casts follow.

Readings on this configuration (RMS gaps):
- Module by module, each given the JAX module's own input (teacher-forced),
  the port's bfloat16 output is JAX's to rounding flips: every convolution,
  dense layer, GroupNorm, ResBlock and AttentionBlock of the depth
  predictor within 0.148 of the JAX module's own bfloat16-to-float32 gap
  (most 0, i.e. equal bits; the largest are GroupNorms, whose float32
  statistics JAX takes as E[x^2] - E[x]^2), and the stages 4c, 4d and 4f
  and the glue of 4e within 0.022
  (`test_modules_and_stages_match_jax_at_bf16`; bound 0.25).
- End to end the bound 0.25 cannot hold, on the port or on JAX itself: the
  port's float32 backbone and matcher differ from JAX's by ~1e-6 relative
  (summation order), the first bfloat16 casts turn that into last-bit flips
  and each convolution spreads them. JAX's own bfloat16 Gaussians move by
  0.88-0.93 of its bfloat16-to-float32 gap when its input images move by
  1e-6; the port's sit at 0.73-0.81 of that gap from JAX's
  (`test_encoder_outputs_match_jax_at_bf16` holds both the gap to JAX's
  perturbed run and absolute RMS bounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from flax.linen import intercept_methods

from test_torch_encoder import _tiny_cfgs
from test_torch_modules import random_variables
from transplat_tpu_torch.convert import load_jax_variables
from transplat_tpu_torch.dataset import synthetic_batch
from transplat_tpu_torch.inference import re10k_decoder_cfg
from transplat_tpu_torch.loss import LPIPS, LossCfg
from transplat_tpu_torch.model.encoder import EncoderTranSplat
from transplat_tpu_torch.model.layers import _FlaxBatchNorm
from transplat_tpu_torch.training import create_train_state, make_lr_schedule, make_optimizer
from transplat_tpu_torch.training.step import loss_and_grads

CONTEXT_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")
SHAPE = (64, 64)
STRICT = {"xla_allow_excess_precision": False}
# Teacher-forced: the port's gap to JAX's bfloat16 output over JAX's own gap to float32.
TEACHER_RATIO = 0.25
# End to end, RMS: absolute bounds (readings 0.0170, 0.00133, 0.00228) and
# the gap to JAX's run on images moved by 1e-6 (port / that: 0.83-0.87).
E2E_RMS = {"means": 0.04, "disparities": 0.004, "opacities": 0.006}
E2E_CHAOS_RATIO = 1.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as tests/test_torch_cli.py: tiny models run many
    small ops, whose threads oversubscribe the cores under several workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def strict_jit(fn, *args):
    """fn(*args), compiled with each bfloat16 value rounded where the program rounds it."""
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)


def rms(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def nchw(x):
    return x.permute(0, 3, 1, 2) if x.ndim == 4 else x


def nhwc(x):
    return x.permute(0, 2, 3, 1) if x.ndim == 4 else x


def to_torch(x) -> torch.Tensor:
    """A JAX array as a tensor of the same dtype (bfloat16 or float32)."""
    t = torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def to_np(x) -> np.ndarray:
    return (x.float().numpy() if torch.is_tensor(x) else np.asarray(jnp.asarray(x).astype(jnp.float32)))


@pytest.fixture(scope="module")
def runs():
    """The tiny encoder from one set of JAX variables: JAX at bfloat16 (strict)
    with every module's output (capture_intermediates) and the depth
    predictor's module and stage calls with their inputs (intercepted), JAX
    at float32, JAX at bfloat16 on images moved by 1e-6, and the port at
    both dtypes."""
    from transplat_tpu.model.encoder import EncoderTranSplat as JEnc

    jcfg, tcfg = _tiny_cfgs()
    batch = synthetic_batch(0, image_shape=SHAPE, num_target=2)
    ctx = [batch["context"][k] for k in CONTEXT_KEYS]
    variables = random_variables(JEnc(jcfg), *ctx, seed=11)
    variables["params"]["depth_predictor"]["to_disparity_2"]["kernel"][..., 0] *= 0.01  # see test_torch_encoder.py
    jm = JEnc(dataclasses.replace(jcfg, compute_dtype="bfloat16"))
    calls = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        path = context.module.path
        if len(path) > 1 and path[0] == "depth_predictor" and path[1] not in ("uv_matcher", "cam_param_encoder"):
            calls.append(("/".join(path[1:]), context.method_name, args, out))
        elif path == ("depth_predictor",) and context.method_name in ("cost_unet", "coarse_depth", "refine", "heads"):
            calls.append(("", context.method_name, args, out))
        return out

    def bf16_apply(v, *a):
        calls.clear()
        with intercept_methods(record):
            (g, aux), state = jm.apply(v, *a, return_aux=True, capture_intermediates=True, mutable=["intermediates"])
        # the calls' array arguments and outputs leave the program; shapes and the like stay in `calls`
        arrays = [[x for x in jax.tree.leaves(c[2]) if isinstance(x, jax.Array)] for c in calls]
        return g, aux, state["intermediates"], [(xs, c[3]) for xs, c in zip(arrays, calls)]

    def with_arrays(args, arrays):
        leaves, tree = jax.tree.flatten(args)
        it = iter(arrays)
        return jax.tree.unflatten(tree, [next(it) if isinstance(x, jax.Array) else x for x in leaves])

    jargs = (variables, *(jnp.asarray(a) for a in ctx))
    compiled = strict_jit(bf16_apply, *jargs)
    g, aux, inter, values = compiled(*jargs)
    calls = [(name, method, with_arrays(args, xs), out) for (name, method, args, _), (xs, out) in zip(list(calls), values)]
    moved = list(jargs)
    noise = np.random.default_rng(1).standard_normal(ctx[0].shape)
    moved[1] = jnp.asarray((ctx[0] * (1.0 + 1e-6 * noise)).astype(np.float32))
    g_moved, aux_moved, _, _ = compiled(*moved)
    jm32 = JEnc(jcfg)
    g32, aux32 = jax.jit(lambda v, *a: jm32.apply(v, *a, return_aux=True))(*jargs)

    def outputs(g, aux):
        return {"means": to_np(g.means), "disparities": 1.0 / to_np(aux["depths"]), "opacities": to_np(g.opacities)}

    ports = {}
    for dt in ("bfloat16", "float32"):
        port = EncoderTranSplat(dataclasses.replace(tcfg, compute_dtype=dt), device="cpu")
        load_jax_variables(port, variables)
        ports[dt] = port
    with torch.no_grad():
        tg, taux = ports["bfloat16"](*(torch.from_numpy(a) for a in ctx), return_aux=True)
    return {
        "ctx": ctx, "variables": variables, "intermediates": unfreeze(inter), "calls": calls, "ports": ports,
        "jax_bf16": outputs(g, aux), "jax_moved": outputs(g_moved, aux_moved), "jax_f32": outputs(g32, aux32),
        "port_bf16": outputs(tg, taux),
    }


# ---------------------------------------------------------------------------
# (a) the dtype of every module's output
# ---------------------------------------------------------------------------


def test_module_output_dtypes_match_jax_at_bf16(runs):
    """Every module of the encoder that JAX's capture_intermediates reports
    returns the same dtype in the port (bfloat16 in the depth predictor's
    convolutions, norms and U-Net blocks; float32 in the U-Nets' last norm,
    the backbone, DAv2, the cam encoder and the matcher)."""
    want = {}

    def walk(node, path):
        for k, v in node.items():
            if k == "__call__":
                want["/".join(path)] = tuple(str(x.dtype) for x in jax.tree.leaves(v[0]))
            elif hasattr(v, "items"):
                walk(v, path + [k])

    def port_dtypes(out):  # the tensors of an output (tuples, named tuples, dicts) in JAX's leaf order
        if torch.is_tensor(out):
            return (str(out.dtype).replace("torch.", ""),)
        items = [out[k] for k in sorted(out)] if isinstance(out, dict) else list(out)
        return tuple(d for x in items for d in port_dtypes(x))

    walk(runs["intermediates"], [])
    got = {}
    port = runs["ports"]["bfloat16"]
    def hook(name):
        def record(module, inputs, out):
            got.setdefault(name.replace(".", "/"), port_dtypes(out))  # the first call, as capture_intermediates
        return record

    hooks = [m.register_forward_hook(hook(name)) for name, m in port.named_modules()]
    try:
        with torch.no_grad():
            port(*(torch.from_numpy(a) for a in runs["ctx"]), return_aux=True)
    finally:
        for h in hooks:
            h.remove()
    assert len(want) > 400 and set(want) <= set(got)
    assert {k: got[k] for k in want} == want
    assert sum(v == ("bfloat16",) for v in want.values()) > 120


# ---------------------------------------------------------------------------
# (b) values at bfloat16
# ---------------------------------------------------------------------------


def _call_module(port, name, args):
    """The port's module `name` of the depth predictor on JAX's NHWC arguments."""
    mod = port.depth_predictor.get_submodule(name.replace("/", "."))
    xs = [nchw(to_torch(a)) for a in args]
    tokens_last = name.endswith("attn/norm")  # the attention's GroupNorm: JAX (n, t, c), the port (n, c, t)
    if tokens_last:
        xs = [x.transpose(1, 2) for x in xs]
    with torch.no_grad():
        out = mod(*xs)
    return nhwc(out.transpose(1, 2) if tokens_last else out)


def _call_stage(port, method, args):
    """The port's stage `method` of the depth predictor on JAX's arguments;
    {name: numpy NHWC}, and with the refine stage its refine_conv_in input."""
    dp = port.depth_predictor
    t = [to_torch(a) if hasattr(a, "dtype") else a for a in args]
    seen = {}
    with torch.no_grad():
        if method == "cost_unet":
            return {"raw_corr": to_np(nhwc(dp.cost_unet(*t)))}
        if method == "coarse_depth":
            out = dp.coarse_depth(nchw(t[0]), t[1], t[2])
            return {k: to_np(nhwc(v)) for k, v in out.items()}
        if method == "refine":
            coarse = {k: nchw(to_torch(v)) for k, v in args[4].items()}
            hook = dp.refine_conv_in.register_forward_pre_hook(lambda m, i: seen.update(refine_in=i[0]))
            try:
                _, proj = dp.refine(*t[:4], coarse)
            finally:
                hook.remove()
            return {"proj_feat_fullres": to_np(nhwc(proj)), "refine_in": to_np(nhwc(seen["refine_in"]))}
        depths, densities, raw = dp.heads(nchw(t[0]), nchw(t[1]), t[2], nchw(t[3]), t[4], t[5])
        return {"depths": to_np(depths), "densities": to_np(densities), "raw_gaussians": to_np(raw)}


def _jax_stage_outputs(method, out, calls):
    if method == "cost_unet":
        return {"raw_corr": to_np(out)}
    if method == "coarse_depth":
        return {k: to_np(v) for k, v in out.items()}
    if method == "refine":
        refine_in = next(args[0] for name, m, args, _ in calls if name == "refine_conv_in")
        return {"proj_feat_fullres": to_np(out[1]), "refine_in": to_np(refine_in)}
    return dict(zip(("depths", "densities", "raw_gaussians"), (to_np(x) for x in out)))


def test_modules_and_stages_match_jax_at_bf16(runs):
    """Teacher-forced: each module of the depth predictor that returns
    bfloat16 in JAX (convolutions, dense layers, GroupNorms, ResBlocks,
    AttentionBlocks) and the stages 4c (cost U-Net), 4d (coarse depth), 4e
    (its upsampler, resize and concatenation: the refine U-Net's input and
    the full-resolution features) and 4f (the heads) get JAX's own inputs;
    the port's bfloat16 output is within TEACHER_RATIO of the JAX bfloat16
    output's gap to the port's float32 module on the same inputs."""
    ports, calls = runs["ports"], runs["calls"]
    ratios = {}
    for name, method, args, out in calls:
        if method != "__call__" or out.dtype != jnp.bfloat16:
            continue
        got, exact = (to_np(_call_module(ports[dt], name, args)) for dt in ("bfloat16", "float32"))
        ref = to_np(out)
        ratios[name] = rms(got, ref) / rms(exact, ref)
    stages = {}
    for name, method, args, out in calls:
        if name:
            continue
        got, exact = (_call_stage(ports[dt], method, args) for dt in ("bfloat16", "float32"))
        for key, ref in _jax_stage_outputs(method, out, calls).items():
            stages[f"{method}.{key}"] = rms(got[key], ref) / rms(exact[key], ref)
    assert len(ratios) > 120 and len(stages) == 10
    worst = sorted({**ratios, **stages}.items(), key=lambda kv: -kv[1])[:5]
    print("teacher-forced, worst port / JAX bf16 gap ratios:", worst, "stages:", stages)
    assert all(r <= TEACHER_RATIO for r in ratios.values()), worst
    assert all(r <= TEACHER_RATIO for r in stages.values()), stages


def test_encoder_outputs_match_jax_at_bf16(runs):
    """End to end from the same weights: the port's bfloat16 means,
    disparities and opacities within E2E_RMS of JAX's, no further from them
    than JAX's own bfloat16 run on images moved by 1e-6 (E2E_CHAOS_RATIO),
    and nearer to JAX's bfloat16 result than JAX's float32 result is."""
    readings = {}
    for key, bound in E2E_RMS.items():
        ours, theirs = runs["port_bf16"][key], runs["jax_bf16"][key]
        gap, chaos, rounding = rms(ours, theirs), rms(runs["jax_moved"][key], theirs), rms(runs["jax_f32"][key], theirs)
        readings[key] = dict(gap=gap, chaos=chaos, bf16_vs_f32=rounding, ratio=gap / rounding)
        assert np.isfinite(ours).all() and gap <= bound, (key, readings[key])
        assert gap <= E2E_CHAOS_RATIO * chaos and gap < rounding, (key, readings[key])
    print("end to end (RMS):", readings)


def test_lpips_matches_jax_at_bf16():
    """LPIPS with its VGG convolutions in bfloat16 (the training loss's)
    against the JAX module at dtype=bfloat16: the distances within 1e-3
    relative (reading 2e-5), at most TEACHER_RATIO of JAX's own
    bfloat16-to-float32 gap; the float32 call is unchanged."""
    from transplat_tpu.loss.vgg import LPIPS as JLPIPS

    zeros = np.zeros((1, 32, 32, 3), np.float32)
    params = random_variables(JLPIPS(), zeros, zeros, seed=5)["params"]
    port = LPIPS(device="cpu")
    load_jax_variables(port, {"params": params})
    a, b = np.random.default_rng(0).random((2, 3, 32, 32, 3), np.float32)
    args = ({"params": params}, jnp.asarray(a), jnp.asarray(b))
    jl16 = JLPIPS(dtype=jnp.bfloat16)
    ref16 = np.asarray(strict_jit(jl16.apply, *args)(*args))
    ref32 = np.asarray(jax.jit(JLPIPS().apply)(*args))
    got16 = port(torch.from_numpy(a), torch.from_numpy(b), dtype=torch.bfloat16)
    got32 = port(torch.from_numpy(a), torch.from_numpy(b))
    assert got16.dtype == torch.float32 and got16.shape == (3,)
    np.testing.assert_allclose(got16.numpy(), ref16, rtol=1e-3)
    assert rms(got16.numpy(), ref16) <= TEACHER_RATIO * rms(ref32, ref16), (got16, ref16, ref32)
    np.testing.assert_allclose(got32.numpy(), ref32, rtol=1e-5)


def test_staged_encoder_follows_the_compute_dtype(runs):
    """The staged encoder is the encoder's own forward: at bfloat16 its
    Gaussians are the fused encoder's bit for bit."""
    from transplat_tpu_torch.evaluation.staged import StagedEncoder

    port = runs["ports"]["bfloat16"]
    ctx = dict(zip(CONTEXT_KEYS, runs["ctx"]))
    staged, _ = StagedEncoder(port).run(ctx)
    with torch.no_grad():
        fused = port(*(torch.from_numpy(a) for a in runs["ctx"]))
    assert all(torch.equal(a, b) for a, b in zip(staged, fused))
    np.testing.assert_array_equal(staged.means.numpy(), runs["port_bf16"]["means"])


# ---------------------------------------------------------------------------
# (e), (f) gradient checkpointing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_inputs():
    _, tcfg = _tiny_cfgs()
    batch = synthetic_batch(0, image_shape=SHAPE, num_target=2)
    tbatch = {side: {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in batch[side].items() if k != "index"}
              for side in ("context", "target")}
    base = create_train_state(tcfg, make_optimizer(make_lr_schedule(2e-4, 1000)), device="cpu", seed=3)
    return tcfg, tbatch, base.encoder.state_dict()


def _checkpointed_step(cfg, tbatch, weights):
    """Loss, gradients, BatchNorm statistics and the generator's state after
    one forward and backward in training mode, dropout on."""
    state = create_train_state(cfg, make_optimizer(make_lr_schedule(2e-4, 1000)), LPIPS(device="cpu"), device="cpu")
    state.encoder.load_state_dict(weights)
    gen = torch.Generator().manual_seed(7)
    metrics, grads = loss_and_grads(state, tbatch, LossCfg(), re10k_decoder_cfg(), SHAPE, generator=gen)
    stats = {k: v.clone() for k, v in state.encoder.state_dict().items() if "running" in k}
    return float(metrics["loss"]), grads, stats, gen.get_state()


@pytest.mark.parametrize("setting", [
    dict(remat_unet=True), dict(remat_matching=True), dict(remat_unet=True, remat_matching=True),
    dict(remat_unet=True, remat_matching=True, compute_dtype="bfloat16"),
])
def test_checkpointed_step_equals_plain_bit_for_bit(step_inputs, setting, monkeypatch):
    """With dropout on, a step with the U-Nets and / or the UV fine layers
    checkpointed gives the plain step's loss, every gradient leaf, the
    BatchNorm statistics and the dropout generator's final state bit for bit
    (the recomputation replays the forward's masks and puts the generator
    back). Under remat_matching the fine layers' samplers run twice: the
    value sampler (K7 on the card) and the P = 4 score sampler (K5) are
    called 2 x 2 times, the P = 1 coarse sampler once."""
    from transplat_tpu_torch.model import uv_transformer

    cfg, tbatch, weights = step_inputs
    plain_cfg = dataclasses.replace(cfg, compute_dtype=setting.get("compute_dtype", "float32"))
    counts = {"vectors": 0, "scores_p1": 0, "scores_p4": 0}
    vectors, scores = uv_transformer.deform_sample_vectors, uv_transformer.deform_sample_scores

    def count_vectors(*a, **k):
        counts["vectors"] += 1
        return vectors(*a, **k)

    def count_scores(s, hw, loc, *a, **k):
        counts["scores_p1" if loc.shape[-2] == 1 else "scores_p4"] += 1
        return scores(s, hw, loc, *a, **k)

    monkeypatch.setattr(uv_transformer, "deform_sample_vectors", count_vectors)
    monkeypatch.setattr(uv_transformer, "deform_sample_scores", count_scores)
    plain = _checkpointed_step(plain_cfg, tbatch, weights)
    plain_counts = dict(counts)
    counts.update(vectors=0, scores_p1=0, scores_p4=0)
    got = _checkpointed_step(dataclasses.replace(plain_cfg, **setting), tbatch, weights)
    assert got[0] == plain[0] and np.isfinite(got[0])
    assert set(got[1]) == set(plain[1])
    differ = [k for k in plain[1] if not torch.equal(got[1][k], plain[1][k])]
    assert not differ, differ[:5]
    assert all(torch.equal(got[2][k], plain[2][k]) for k in plain[2]) and len(plain[2]) == 8
    assert torch.equal(got[3], plain[3])  # the generator stands where the plain step leaves it
    fine = 2 if setting.get("remat_matching") else 1
    assert plain_counts == {"vectors": 2, "scores_p1": 1, "scores_p4": 2}
    assert counts == {"vectors": 2 * fine, "scores_p1": 1, "scores_p4": 2 * fine}


def test_no_batch_norm_inside_a_checkpointed_region():
    """The checkpointed regions (both U-Nets, each UV fine layer) hold no
    BatchNorm, whose running statistics a recomputation would move twice;
    the cam-param encoders' BatchNorms sit outside them."""
    _, tcfg = _tiny_cfgs()
    enc = EncoderTranSplat(dataclasses.replace(tcfg, remat_unet=True, remat_matching=True), device="cpu")
    dp = enc.depth_predictor
    regions = [dp.corr_unet, dp.refine_unet] + [getattr(dp.uv_matcher, f"fine_{i}") for i in range(2)]
    assert dp.corr_unet.remat and dp.refine_unet.remat and dp.uv_matcher.remat
    norms = (_FlaxBatchNorm, torch.nn.modules.batchnorm._BatchNorm)
    assert not [m for r in regions for m in r.modules() if isinstance(m, norms)]
    assert [m for m in enc.modules() if isinstance(m, norms)]  # there are BatchNorms, outside


# ---------------------------------------------------------------------------
# (g), (h) the configuration and the command line
# ---------------------------------------------------------------------------


def test_s2d_with_bf16_is_refused_as_in_jax():
    """s2d_unet with compute_dtype="bfloat16" raises the JAX package's
    ValueError in both packages, built directly or by load_config (the re10k
    preset sets s2d_unet); an unknown compute dtype raises in the port."""
    from transplat_tpu import config as jax_config
    from transplat_tpu.model.encoder import EncoderCfg as JE
    from transplat_tpu_torch import config as port_config
    from transplat_tpu_torch.model.encoder import EncoderCfg as TE

    first = "s2d_unet=True requires compute_dtype='float32'"
    for make in (JE, TE):
        with pytest.raises(ValueError, match=first):
            make(s2d_unet=True, compute_dtype="bfloat16")
    for cfg in (jax_config, port_config):
        with pytest.raises(ValueError, match=first):
            cfg.load_config("re10k", encoder=dict(compute_dtype="bfloat16"))
        enc = cfg.load_config("re10k", encoder=dict(compute_dtype="bfloat16", s2d_unet=False, remat_unet=True,
                                                    remat_matching=True)).encoder
        assert (enc.compute_dtype, enc.remat_unet, enc.remat_matching) == ("bfloat16", True, True)
    with pytest.raises(ValueError, match="compute_dtype 'bf16'"):
        TE(compute_dtype="bf16")


def test_main_train_and_test_run_with_bf16_and_checkpointing(tmp_path, monkeypatch, capsys):
    """`main train --device cpu` takes 2 steps with the three overrides (the
    run's config records them), and `main test` scores a scene from its
    checkpoint with them."""
    import json

    from test_torch_cli import TINY_YAML
    from transplat_tpu_torch.dataset import chunks
    from transplat_tpu_torch.main import main

    monkeypatch.chdir(tmp_path)
    chunks.write_chunk(tmp_path / "data" / "train" / "000000.torch", [chunks.make_scene("tr_0", 30, seed=0)])
    chunks.write_chunk(tmp_path / "data" / "test" / "000000.torch", [chunks.make_scene("te_0", 60, seed=5)])
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    run = tmp_path / "run"
    overrides = ["encoder.compute_dtype=bfloat16", "encoder.remat_unet=true", "encoder.remat_matching=true",
                 "encoder.s2d_unet=false", "trainer.num_sanity_val_steps=0", "trainer.val_save_media=false"]
    assert main(["train", "--config", "tiny.yaml", "--dataset-root", str(tmp_path / "data"), "--max-steps", "2",
                 "--output", str(run), "--device", "cpu", *overrides]) == 0
    assert "trained to step 2" in capsys.readouterr().out
    steps = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r["loss"]) for r in steps if "loss" in r)
    saved = json.loads((run / "checkpoints" / "config.json").read_text())["encoder"]
    assert (saved["compute_dtype"], saved["remat_unet"], saved["remat_matching"]) == ("bfloat16", True, True)
    index, scores = tmp_path / "index.json", tmp_path / "scores"
    assert main(["generate-index", "--dataset-root", str(tmp_path / "data"), "--output", str(index), "--device", "cpu"]) == 0
    assert main(["test", "--config", "tiny.yaml", "--dataset-root", str(tmp_path / "data"), "--evaluation-index",
                 str(index), "--checkpoint", str(run / "checkpoints"), "--output", str(scores), "--device", "cpu",
                 *overrides[:4]]) == 0
    per_scene = json.loads((scores / "scores_per_scene.json").read_text())
    assert list(per_scene) == ["te_0"] and all(np.isfinite(per_scene["te_0"][k]) for k in ("psnr", "ssim", "lpips"))
