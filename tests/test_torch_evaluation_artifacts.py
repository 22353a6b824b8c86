"""Evaluation from weight files with every artifact, port vs JAX package.

  * utils/analysis.py: the four analysis functions on the same numpy inputs,
    1e-5 relative, integer counts exact;
  * the encoder's `return_aux` against the JAX encoder's aux (test_torch_encoder's
    1e-3), and StagedEncoder: the port's fused encoder bit for bit (the same
    operations in the same order) with all ten stage tags, and the JAX
    StagedEncoder within 1e-3;
  * visualization/ and utils/image_io.py: trajectories, layout, colour map,
    PLY bytes and PNG bytes identical to the JAX package's on the same
    arrays; a video written and read back;
  * MetricComputer.summarize against JAX's on the same PNG directories:
    PSNR 1e-4 dB, SSIM 1e-5, LPIPS (the same loaded weights) 1e-5 relative;
  * Evaluator.run with every artifact flag against the JAX Evaluator on the
    same seeded chunks and weights: the same files, PSNR within 0.05 dB,
    SSIM within 1e-3 (test_evaluator_scores_match_jax's bounds), LPIPS with
    the same loaded weights within 1e-3 relative (measured: 8.6e-6 and
    2.8e-7 on the two scenes).

Tiny encoder widths (d_feature 16) at 32x32.
"""

import copy
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_encoder import _tiny_cfgs
from test_torch_modules import random_variables
from chip_smoke import seeded_lpips_state as lpips_state_dict

SHAPE = (32, 32)
CTX_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: several test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    """Seeded JAX variables of the tiny encoder, the port encoder loaded from
    them, and a 32x32 batch with two target views."""
    from transplat_tpu.model.encoder import EncoderTranSplat as JEnc
    from transplat_tpu_torch.convert import load_jax_variables
    from transplat_tpu_torch.dataset import synthetic_batch
    from transplat_tpu_torch.model.encoder import EncoderTranSplat as TEnc

    jcfg, tcfg = _tiny_cfgs()
    batch = synthetic_batch(0, image_shape=SHAPE, num_target=2)
    ctx = [batch["context"][k] for k in CTX_KEYS]
    jm = JEnc(jcfg)
    variables = random_variables(jm, *ctx, seed=41)
    variables["params"]["depth_predictor"]["to_disparity_2"]["kernel"][..., 0] *= 0.01  # depths off the 1/far clip
    port = load_jax_variables(TEnc(tcfg, device="cpu"), variables)
    return jm, jcfg, variables, port, batch, ctx


# ---------------------------------------------------------------------------
# utils/analysis.py
# ---------------------------------------------------------------------------


def _analysis_inputs(rng):
    depths = rng.uniform(1.0, 10.0, (1, 2, 16, 16)).astype(np.float32)
    depths[..., ::2, :] = depths[..., 1::2, :]  # every other row repeats its neighbour: some similar pairs
    logits = rng.normal(0, 3, (1, 2, 4, 4, 16)).astype(np.float32)
    pdf = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    features = rng.normal(size=(1, 2, 4, 4, 8)).astype(np.float32)
    features[..., :4] += 3.0  # a shared direction: some pairs are feature-similar
    radii = rng.integers(0, 4, (1, 2, 512)).astype(np.int32)
    opacities = rng.uniform(0, 0.05, (1, 2, 512)).astype(np.float32)
    return {
        "contribution": ((radii, opacities), {}),
        "adjacent": ((depths, None), {}),
        "pdf": ((pdf,), {}),
        "feature_depth": ((features, depths), {"num_pairs": 512}),
    }


FUNCTIONS = {
    "contribution": "gaussian_contribution_stats",
    "adjacent": "adjacent_gaussian_similarity",
    "pdf": "depth_pdf_stats",
    "feature_depth": "feature_depth_correlation",
}


@pytest.mark.parametrize("group", list(FUNCTIONS))
def test_analysis_matches_jax(group):
    from transplat_tpu.utils import analysis as jax_analysis
    from transplat_tpu_torch.utils import analysis

    args, kwargs = _analysis_inputs(np.random.default_rng(7))[group]
    name = FUNCTIONS[group]
    want = getattr(jax_analysis, name)(*(None if a is None else jnp.asarray(a) for a in args), **kwargs)
    got = getattr(analysis, name)(*(None if a is None else torch.from_numpy(a) for a in args), **kwargs)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert type(got[k]) is type(v), k
        if isinstance(v, int):
            assert got[k] == v, k  # counts exactly
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-12, err_msg=k)


# ---------------------------------------------------------------------------
# the encoder's aux outputs and the staged encoder
# ---------------------------------------------------------------------------


def _disparity(x):
    return 1.0 / np.asarray(x)


def test_return_aux_matches_jax_aux(pair, eval_runs):
    jm, _, variables, port, _, ctx = pair
    jax_evaluator = eval_runs[4]
    with torch.no_grad():
        plain = port(*(torch.from_numpy(a) for a in ctx))
        gaussians, aux = port(*(torch.from_numpy(a) for a in ctx), return_aux=True)
    for a, b in zip(plain, gaussians):
        assert torch.equal(a, b)  # return_aux leaves the Gaussians as they are
    # The JAX Evaluator's jitted encode with return_aux, compiled by its run.
    _, want = jax_evaluator._encode_aux(*(jnp.asarray(a) for a in ctx))
    assert sorted(aux) == sorted(want) == sorted(
        ["pdf", "coarse_disps", "depth_candidates", "depths", "scales", "rotations", "features"])
    for k in want:
        got, ref = aux[k].numpy(), np.asarray(want[k])
        assert got.shape == ref.shape, k
        if k in ("depths", "depth_candidates"):  # compared as disparities (depths near 1/far)
            got, ref = _disparity(got), _disparity(ref)
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3, err_msg=k)


def test_staged_encoder_equals_fused_bit_for_bit(pair):
    from transplat_tpu_torch.evaluation.staged import STAGES, StagedEncoder
    from transplat_tpu_torch.utils.benchmarker import Benchmarker

    _, _, _, port, batch, ctx = pair
    with torch.no_grad():
        fused, fused_aux = port(*(torch.from_numpy(a) for a in ctx), return_aux=True)
    bench = Benchmarker("cpu")
    staged = StagedEncoder(port)
    gaussians, aux = staged.run(batch["context"], benchmarker=bench)
    for a, b in zip(fused, gaussians):
        assert torch.equal(a, b)
    assert all(torch.equal(aux[k], fused_aux[k]) for k in fused_aux)
    assert list(bench.summarize()) == STAGES and all(s["count"] == 1 for s in bench.summarize().values())
    assert list(staged.memory_analysis()) == STAGES  # empty records on the CPU
    costs = staged.cost_analysis()
    assert list(costs) == STAGES
    assert costs["encoder_2_backbone"]["flops"] > 0 and costs["encoder_4e_depth_refine_unet"]["flops"] > 0
    again, _ = staged.run(batch["context"])  # without a benchmarker
    assert torch.equal(again.means, fused.means)


def test_staged_encoder_matches_jax_staged(pair, eval_runs):
    from transplat_tpu_torch.evaluation.staged import StagedEncoder

    _, _, _, port, batch, _ = pair
    jax_staged = eval_runs[4]._staged  # the JAX Evaluator's StagedEncoder, its stages compiled by its run
    ref, ref_aux = jax_staged.run({k: jnp.asarray(v) for k, v in batch["context"].items()})
    got, aux = StagedEncoder(port).run(batch["context"])
    for name in ("means", "covariances", "harmonics", "opacities"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-3, rtol=1e-3,
                                   err_msg=name)
    np.testing.assert_allclose(aux["pdf"].numpy(), np.asarray(ref_aux["pdf"]).reshape(aux["pdf"].shape), atol=1e-3)
    np.testing.assert_allclose(aux["depth_candidates"].numpy(), np.asarray(ref_aux["depth_candidates"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# visualization/ and utils/image_io.py: the JAX package's numpy code, copied
# ---------------------------------------------------------------------------


def _cameras(rng):
    from transplat_tpu_torch.dataset import chunks
    from transplat_tpu_torch.dataset.re10k import convert_poses

    extr, intr = convert_poses(chunks.orbit_poses(40, yaw_deg_per_frame=0.9, slide_per_frame=0.05))
    return extr[0], extr[39], intr[0], intr[39]


@pytest.mark.parametrize("name", ["wobble", "interpolate_extrinsics", "interpolate_intrinsics", "spin"])
def test_trajectories_equal_jax(name):
    from transplat_tpu.visualization import trajectory as jt
    from transplat_tpu_torch.visualization import trajectory as tt

    e0, e1, i0, i1 = _cameras(None)
    t = np.linspace(0, 1, 30)
    calls = {
        "wobble": lambda m: m.generate_wobble(e0, np.asarray(0.3), t),
        "interpolate_extrinsics": lambda m: m.interpolate_extrinsics(e0, e1, t),
        "interpolate_intrinsics": lambda m: m.interpolate_intrinsics(i0, i1, t),
        "spin": lambda m: m.generate_spin(30, elevation_deg=12.0, radius=2.5),
    }
    got, want = calls[name](tt), calls[name](jt)
    assert got.dtype == want.dtype and got.shape == want.shape and got.shape[0] == 30
    np.testing.assert_array_equal(got, want)


def test_layout_and_color_map_equal_jax():
    from transplat_tpu.visualization import add_border as jb, add_label as jl, hcat as jh, vcat as jv
    from transplat_tpu.visualization import apply_color_map_to_image as jc
    from transplat_tpu_torch.visualization import add_border, add_label, apply_color_map_to_image, hcat, vcat

    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (20, 12, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (14, 18, 3)).astype(np.float32)
    depth = rng.uniform(1, 9, (16, 16)).astype(np.float32)
    pairs = [
        (hcat(a, b), jh(a, b)), (vcat(a, b, gap=3, value=0.0), jv(a, b, gap=3, value=0.0)),
        (add_border(a, 5), jb(a, 5)), (add_label(a, "ours"), jl(a, "ours")),
        (add_label(depth, "depth"), jl(depth, "depth")),
        (apply_color_map_to_image(depth), jc(depth)), (apply_color_map_to_image(depth, invert=True), jc(depth, True)),
    ]
    for got, want in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_ply_bytes_equal_jax(tmp_path):
    from transplat_tpu.visualization.ply_export import export_ply as jax_export
    from transplat_tpu_torch.visualization.ply_export import export_ply, read_ply

    rng = np.random.default_rng(0)
    g = 3000
    args = [rng.normal(size=(g, 3)), rng.uniform(0.01, 0.1, (g, 3)), rng.normal(size=(g, 4)),
            rng.normal(size=(g, 3, 4)), rng.uniform(0, 1, g)]
    args = [a.astype(np.float32) for a in args]
    args[2][:5] = [[0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0.5, 0.5, 0.5, 0.5]]  # every branch
    export_ply(*args, tmp_path / "port.ply")
    jax_export(*args, tmp_path / "jax.ply")
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    names, data = read_ply(tmp_path / "port.ply")
    assert data.shape == (g, 6 + 3 + 9 + 1 + 3 + 4) and names[-4:] == ["rot_0", "rot_1", "rot_2", "rot_3"]
    np.testing.assert_allclose(np.linalg.norm(data[:, -4:], axis=1), 1.0, atol=1e-5)  # unit quaternions


def test_png_bytes_equal_jax_and_video_round_trip(tmp_path):
    from transplat_tpu.utils.image_io import load_image as jax_load, save_image as jax_save
    from transplat_tpu_torch.utils.image_io import load_image, load_video, save_image, save_video, to_uint8

    rng = np.random.default_rng(1)
    image = rng.uniform(-0.1, 1.1, (24, 40, 3)).astype(np.float32)
    save_image(image, tmp_path / "a" / "port.png")
    jax_save(image, tmp_path / "b" / "jax.png")
    assert (tmp_path / "a" / "port.png").read_bytes() == (tmp_path / "b" / "jax.png").read_bytes()
    np.testing.assert_array_equal(load_image(tmp_path / "a" / "port.png"), jax_load(tmp_path / "b" / "jax.png"))
    # 30 smooth frames (an mp4 is lossy): the frame count, the size and the pixels come back.
    yy, xx = np.mgrid[0:64, 0:48] / 64.0
    frames = [np.stack([xx, yy, np.full_like(xx, t / 30)], -1).astype(np.float32) for t in range(30)]
    save_video(frames, tmp_path / "v" / "clip.mp4")
    back = load_video(tmp_path / "v" / "clip.mp4")
    assert back.shape == (30, 64, 48, 3) and back.dtype == np.uint8
    err = np.abs(back.astype(np.float32) - np.stack([to_uint8(f) for f in frames]).astype(np.float32))
    assert err.mean() < 4.0, err.mean()  # of 255


# ---------------------------------------------------------------------------
# MetricComputer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lpips_pair():
    from transplat_tpu.loss.vgg import LPIPS as JLPIPS
    from transplat_tpu.training.step import init_lpips_params
    from transplat_tpu_torch.loss.vgg import init_lpips

    state = lpips_state_dict("torchvision", seed=11)
    params = init_lpips_params(SHAPE, state)
    return state, init_lpips(state, "cpu"), lambda p, g: JLPIPS().apply({"params": params}, p, g)


def test_metric_computer_matches_jax(tmp_path, lpips_pair):
    from transplat_tpu.evaluation.metric_computer import MetricComputer as JMC
    from transplat_tpu.evaluation.metric_computer import MetricComputerCfg as JCfg
    from transplat_tpu_torch.evaluation.metric_computer import MetricComputer, MetricComputerCfg
    from transplat_tpu_torch.utils.image_io import save_image

    _, lpips, jax_lpips = lpips_pair
    rng = np.random.default_rng(2)
    for scene in ("s0", "s1"):
        for t in range(4):
            img = rng.uniform(0, 1, (*SHAPE, 3)).astype(np.float32)
            save_image(img, tmp_path / "gt" / scene / "color" / f"{t:04d}.png")
            save_image(np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1), tmp_path / "a" / scene / "color" / f"{t:04d}.png")
            save_image(np.clip(img + 0.1, 0, 1), tmp_path / "b" / scene / "color" / f"{t:04d}.png")
    methods = {"a": str(tmp_path / "a"), "b": str(tmp_path / "b")}

    def run(cls, cfg_cls, out, fn, **kw):
        mc = cls(cfg_cls(methods=methods, ground_truth=str(tmp_path / "gt"), output_path=str(tmp_path / out),
                         side_by_side=True, animate_side_by_side=True), lpips_fn=fn, **kw)
        for scene in ("s0", "s1", "missing"):
            mc.process_scene(scene)
        return mc.summarize()

    got = run(MetricComputer, MetricComputerCfg, "port", lpips, device="cpu")
    want = run(JMC, JCfg, "jax", jax_lpips)
    assert json.loads((tmp_path / "port" / "summary.json").read_text()) == got
    assert sorted(got) == sorted(want) == ["a", "b"]
    for m in got:
        assert sorted(got[m]) == sorted(want[m]) == ["lpips", "psnr", "ssim"]
        assert abs(got[m]["psnr"] - want[m]["psnr"]) < 1e-4
        assert abs(got[m]["ssim"] - want[m]["ssim"]) < 1e-5
        np.testing.assert_allclose(got[m]["lpips"], want[m]["lpips"], rtol=1e-5)
    for sub in ("side_by_side", "videos"):
        assert sorted(os.listdir(tmp_path / "port" / sub)) == sorted(os.listdir(tmp_path / "jax" / sub))
    assert (tmp_path / "port" / "side_by_side" / "s0.png").read_bytes() == \
        (tmp_path / "jax" / "side_by_side" / "s0.png").read_bytes()


# ---------------------------------------------------------------------------
# Evaluator.run with every artifact, against the JAX Evaluator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_runs(pair, lpips_pair, tmp_path_factory):
    """Both Evaluators over the same two seeded RE10K-format test scenes
    (an evaluation index of 2 context + 2 target views each), the same
    encoder and LPIPS weights, every artifact flag on."""
    from transplat_tpu import config as jax_config
    from transplat_tpu.evaluation.evaluator import Evaluator as JEvaluator
    from transplat_tpu.training.step import init_lpips_params
    from transplat_tpu_torch import config as port_config
    from transplat_tpu_torch.dataset import chunks
    from transplat_tpu_torch.evaluation import Evaluator

    _, jcfg, variables, port, _, _ = pair
    state, lpips, _ = lpips_pair
    tmp = tmp_path_factory.mktemp("artifacts")
    chunks.write_chunk(tmp / "data" / "test" / "000000.torch",
                       [chunks.make_scene(f"scene_{i}", 30, seed=3 + i) for i in range(2)])
    index = tmp / "index.json"
    index.write_text(json.dumps({f"scene_{i}": {"context": [2, 20], "target": [8, 14]} for i in range(2)}))
    test = dict(evaluation_index=str(index), eval_time_skip_steps=0, stage_timing=True, analyze=True,
                save_video=True, save_ply=True, save_image=True)
    dataset = dict(image_shape=SHAPE, roots=[str(tmp / "data")])
    jax_cfg = jax_config.load_config(
        "re10k", dataset=dataset, decoder=dict(rasterize=dict(mode="tiled", binning="fast", capacity=4096, chunk=128)),
        test=dict(test, output_path=str(tmp / "jax")),
    )
    jax_cfg.encoder = jcfg
    port_cfg = port_config.load_config("re10k", dataset=dataset, test=dict(test, output_path=str(tmp / "port")))
    port_cfg.encoder = port.cfg
    jax_evaluator = JEvaluator(jax_cfg, copy.deepcopy(variables), init_lpips_params(SHAPE, state))
    jax_scores = jax_evaluator.run(save_images=True)
    ev = Evaluator(port_cfg, port, lpips, device="cpu")
    scores = ev.run(save_images=True)
    return ev, scores, jax_scores, tmp, jax_evaluator


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_evaluator_run_writes_the_jax_files_and_scores(eval_runs):
    ev, scores, jax_scores, tmp, _ = eval_runs
    assert _files(tmp / "port") == _files(tmp / "jax")
    assert "scene_0/color/0001.png" in _files(tmp / "port") and "scene_1/gaussians.ply" in _files(tmp / "port")
    assert sorted(scores) == sorted(jax_scores) == ["scene_0", "scene_1"]
    for scene, ref in jax_scores.items():
        got = scores[scene]
        assert sorted(got) == sorted(ref) == ["lpips", "psnr", "render_overflow", "ssim"]
        assert abs(got["psnr"] - ref["psnr"]) < 0.05, (got["psnr"], ref["psnr"])
        assert abs(got["ssim"] - ref["ssim"]) < 1e-3, (got["ssim"], ref["ssim"])
        assert abs(got["lpips"] - ref["lpips"]) < 1e-3 * abs(ref["lpips"]), (got["lpips"], ref["lpips"])


def test_evaluator_artifacts_read_back(eval_runs):
    from transplat_tpu_torch.evaluation.staged import STAGES
    from transplat_tpu_torch.utils.image_io import load_image, load_video
    from transplat_tpu_torch.visualization.ply_export import read_ply

    ev, scores, _, tmp, _ = eval_runs
    out = tmp / "port"
    bench = json.loads((out / "benchmark.json").read_text())
    assert set(STAGES) | {"encoder", "decoder"} == set(bench["summary"])
    jbench = json.loads((tmp / "jax" / "benchmark.json").read_text())
    assert set(bench["summary"]) == set(jbench["summary"])
    for scene in scores:
        for name in ("wobble", "interpolation"):
            frames = load_video(out / scene / f"{name}.mp4")
            assert frames.shape == (30, *SHAPE, 3)
        names, data = read_ply(out / scene / "gaussians.ply")
        jnames, jdata = read_ply(tmp / "jax" / scene / "gaussians.ply")
        assert names == jnames and data.shape == jdata.shape == (2 * SHAPE[0] * SHAPE[1], len(names))
        assert load_image(out / scene / "color" / "0000.png").shape == (*SHAPE, 3)
    per = json.loads((out / "analysis_per_scene.json").read_text())
    jper = json.loads((tmp / "jax" / "analysis_per_scene.json").read_text())
    assert per.keys() == jper.keys()
    for scene in per:
        assert {g: sorted(v) for g, v in per[scene].items()} == {g: sorted(v) for g, v in jper[scene].items()}
        assert per[scene]["contribution"]["total_gaussians"] == jper[scene]["contribution"]["total_gaussians"]
        np.testing.assert_allclose(per[scene]["pdf"]["mean_entropy"], jper[scene]["pdf"]["mean_entropy"], rtol=1e-3)
    avg = json.loads((out / "analysis_avg.json").read_text())
    assert avg.keys() == json.loads((tmp / "jax" / "analysis_avg.json").read_text()).keys()


def test_video_frames_decode_the_trajectories(eval_runs, pair):
    """render_video's frames are decode_splatting of the trajectory cameras,
    and its cameras are the JAX Evaluator's."""
    from transplat_tpu_torch.evaluation.evaluator import video_cameras
    from transplat_tpu_torch.model.decoder import decode_splatting
    from transplat_tpu_torch.visualization import generate_wobble

    ev = eval_runs[0]
    _, _, _, port, batch, ctx = pair
    cams = video_cameras(batch, num_frames=5)
    extr = batch["context"]["extrinsics"][0]
    delta = np.linalg.norm(extr[0, :3, 3] - extr[-1, :3, 3]) * 0.25 + 1e-3
    np.testing.assert_array_equal(cams["wobble"][0], generate_wobble(extr[0], np.asarray(delta), np.linspace(0, 1, 5))
                                  .astype(np.float32))
    videos = ev.render_video(batch, Path(ev.cfg.test.output_path) / "probe", num_frames=5)
    with torch.no_grad():
        gaussians = port(*(torch.from_numpy(a) for a in ctx))
        near = torch.full((1, 5), float(ctx[3][0, 0]))
        want = decode_splatting(gaussians, torch.from_numpy(cams["interpolation"][0])[None],
                                torch.from_numpy(cams["interpolation"][1])[None], near, near * 0 + float(ctx[4][0, 0]),
                                SHAPE).color[0].numpy()
    np.testing.assert_array_equal(videos["interpolation"], want)
