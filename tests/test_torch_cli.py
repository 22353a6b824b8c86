"""The port's command line (python -m transplat_tpu_torch.main) and bench on the CPU.

Each mode runs at a tiny size with --device cpu, in this process
(`main(argv)`), over chunks written from a seed: generate-index against the
JAX package's command line on the same chunks, train (a narrow encoder at
64x64 from a YAML override) with its held-out validation, test on its
checkpoint (also with --save-image), test from weight files with every
artifact and compute-metrics against the JAX command line, the refusals,
and the bench at a tiny size.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from transplat_tpu_torch import bench
from transplat_tpu_torch.dataset import chunks
from transplat_tpu_torch.main import main
from transplat_tpu_torch.train_demo import tiny_encoder_cfg

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny CPU models run thousands of small ops: with several test workers
    on one machine, each op's OpenMP threads oversubscribe the cores (the
    CLI tests' tiny training read 300 s in the parallel suite against 6 s
    alone). One thread per worker keeps the file at its own cost."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

TINY_YAML = """
dataset:
  image_shape: [64, 64]
encoder:
  d_feature: 16
  num_depth_candidates: 16
  costvolume_unet_feat_dim: 16
  costvolume_unet_channel_mult: [1, 1]
  costvolume_unet_attn_res: [2]
  depth_unet_feat_dim: 8
  depth_unet_attn_res: [4]
  depth_unet_channel_mult: [1, 1, 1]
  dav2_encoder: vits
  dav2_input_size: 28
  gaussian_adapter:
    sh_degree: 1
trainer:
  batch_size: 1
  num_workers: 0
  num_sanity_val_steps: 1
  val_check_interval: 2
  max_steps: 2
"""


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """train/: 2 scenes x 30 frames; test/: 2 scenes x 60 frames on paths the
    index generator accepts, and a 30-frame scene it cannot use; 360x640."""
    root = tmp_path_factory.mktemp("cli_port")
    chunks.write_chunk(root / "train" / "000000.torch", [chunks.make_scene(f"tr_{i}", 30, seed=i) for i in range(2)])
    chunks.write_chunk(root / "test" / "000000.torch", [chunks.make_scene(f"te_{i}", 60, seed=5 + i) for i in range(2)])
    chunks.write_chunk(root / "test" / "000001.torch", [chunks.make_scene("te_short", 30, seed=9)])
    return root


def jax_cli(args, cwd):
    env = {"PYTHONPATH": str(ROOT), "PATH": os.environ.get("PATH", "/usr/bin:/bin"), "JAX_PLATFORMS": "cpu",
           "JAX_PLATFORM_NAME": "cpu", "HOME": str(cwd)}
    return subprocess.run([sys.executable, "-m", "transplat_tpu.main", *args], capture_output=True, text=True,
                          cwd=str(cwd), env=env, timeout=600)


def test_generate_index_equals_jax_cli(data_root, tmp_path, capsys):
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    assert main(["generate-index", "--dataset-root", str(data_root), "--output", str(ours), "--device", "cpu"]) == 0
    assert "with 3 scenes" in capsys.readouterr().out
    proc = jax_cli(["generate-index", "--dataset-root", str(data_root), "--output", str(theirs)], tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    index = json.loads(ours.read_text())
    assert index == json.loads(theirs.read_text())
    assert index["te_short"] is None and all(index[f"te_{i}"] is not None for i in range(2))
    for i in range(2):
        left, right = index[f"te_{i}"]["context"]
        assert right - left >= 45 and all(left <= t <= right for t in index[f"te_{i}"]["target"])


def test_generate_video_index_equals_jax(data_root, tmp_path):
    """--video-index (dense targets) against the JAX generator on the same poses."""
    from transplat_tpu.evaluation.index_generator import EvaluationIndexGenerator as JaxGen
    from transplat_tpu.evaluation.index_generator import IndexGeneratorCfg as JaxCfg
    from transplat_tpu_torch.dataset.re10k import convert_poses

    out = tmp_path / "video.json"
    assert main(["generate-index", "--video-index", "--dataset-root", str(data_root), "--output", str(out),
                 "--device", "cpu"]) == 0
    ref = JaxGen(JaxCfg(dense_targets=True))
    for path in sorted((data_root / "test").glob("*.torch")):
        for raw in torch.load(path, weights_only=False):
            ref.process_scene(raw["key"], *convert_poses(np.asarray(raw["cameras"], np.float32)))
    index = json.loads(out.read_text())
    assert index == json.loads(json.dumps(ref.index))
    left, right = index["te_0"]["context"]
    assert index["te_0"]["target"] == list(range(left, right + 1))


def test_train_without_data_fails_fast(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="no training chunks"):
        main(["train", "--dataset-root", str(tmp_path / "missing"), "--max-steps", "1", "--device", "cpu"])
    # the run directory and the latest-run link come before the guard
    assert (tmp_path / "outputs" / "latest-run").is_symlink()
    assert (tmp_path / "outputs" / "latest-run").resolve().parent == (tmp_path / "outputs" / "runs").resolve()
    # --dp / --sp train over ranks under torchrun (tests/test_torch_parallel.py); alone, one process is not two ranks
    with pytest.raises(SystemExit, match=r"dp \* sp must equal the number of ranks \(1\); run under torchrun"):
        main(["train", "--dp", "2", "--device", "cpu"])
    if not torch.cuda.is_available():  # no card and no --device cpu: the port does not carry on on the CPU
        with pytest.raises(SystemExit, match="no CUDA card"):
            main(["generate-index", "--dataset-root", str(tmp_path)])


def test_tiny_train_validates_held_out_then_test_scores(data_root, tmp_path, monkeypatch, capsys):
    """Two training steps on the train split; every validation reads a scene
    of the test split (the held-out stream), a checkpoint is written; then
    `test` scores both indexed test scenes from that checkpoint."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    run = tmp_path / "run"
    assert main(["train", "--config", "tiny.yaml", "--dataset-root", str(data_root), "--max-steps", "2",
                 "--output", str(run), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "JPEG route" in out and "sanity validation" in out and "trained to step 2" in out
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["config.json", "step_00000002.pt"]
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    vals = [r for r in records if "val_psnr" in r]
    assert [r["step"] for r in vals] == [2] and np.isfinite(vals[0]["val_psnr"])
    sanity = [m for m in out.splitlines() if m.startswith("sanity validation")]
    seen = set(vals[0]["val_scenes"]) | {s for m in sanity for s in ("te_0", "te_1", "te_short") if f"'{s}'" in m}
    assert seen and seen <= {"te_0", "te_1", "te_short"}  # keys of the test split only
    assert (tmp_path / "outputs" / "latest-run").resolve() == run.resolve()
    # each validation's media beside metrics.jsonl (the JAX Trainer writes them to ./outputs/local)
    assert sorted(p.name for p in (run / "local").iterdir()) == sorted(
        f"{kind}_{step:08d}.{ext}" for step in (0, 2)
        for kind, ext in (("projections", "png"), ("validation", "png"), ("wobble", "mp4")))
    assert not (tmp_path / "outputs" / "local").exists()

    index = tmp_path / "index.json"
    assert main(["generate-index", "--dataset-root", str(data_root), "--output", str(index), "--device", "cpu"]) == 0
    scores_dir = tmp_path / "scores"
    assert main(["test", "--config", "tiny.yaml", "--dataset-root", str(data_root), "--evaluation-index", str(index),
                 "--checkpoint", str(run / "checkpoints"), "--output", str(scores_dir), "--device", "cpu"]) == 0
    assert "loaded checkpoint at step 2" in capsys.readouterr().out
    per_scene = json.loads((scores_dir / "scores_per_scene.json").read_text())
    assert sorted(per_scene) == ["te_0", "te_1"]
    for s in per_scene.values():
        assert all(np.isfinite(s[k]) for k in ("psnr", "ssim", "lpips")) and s["render_overflow"] == 0
    # --save-image writes each scene's rendered targets (utils/image_io.py)
    assert main(["test", "--config", "tiny.yaml", "--dataset-root", str(data_root), "--evaluation-index", str(index),
                 "--checkpoint", str(run / "checkpoints"), "--output", str(scores_dir), "--save-image",
                 "--device", "cpu"]) == 0
    pngs = sorted(str(p.relative_to(scores_dir)) for p in scores_dir.rglob("*.png"))
    assert pngs == [f"te_{i}/color/{t:04d}.png" for i in range(2) for t in range(len(json.loads(index.read_text())["te_0"]["target"]))]


def test_compute_metrics_names_what_it_waits_for(capsys):
    """Without --ground-truth or a --method, compute-metrics refuses and names
    both, as the JAX command line does (an argparse error, exit code 2)."""
    for argv in (["compute-metrics", "--method", "m=dir"], ["compute-metrics", "--ground-truth", "gt"]):
        with pytest.raises(SystemExit) as exit_info:
            main(argv)
        assert exit_info.value.code == 2
        err = capsys.readouterr().err
        assert "compute-metrics requires --ground-truth and at least one --method name=dir" in err
    with pytest.raises(SystemExit):
        main(["test", "--device", "cpu", "test.no_such_field=1"])  # an override of no config field
    assert "no_such_field" in capsys.readouterr().err


def test_test_from_weight_files_with_every_artifact_then_compute_metrics(data_root, tmp_path, monkeypatch, capsys):
    """`main test` from weight files (a seeded encoder tree in the JAX layout and
    LPIPS weights, given as config overrides) with every artifact; then
    `compute-metrics` over its renders, against the JAX command line's
    summary.json on the same directories (PSNR 1e-4 dB, SSIM 5e-5)."""
    from chip_smoke import seeded_lpips_state as lpips_state_dict
    from transplat_tpu_torch.config import load_config
    from transplat_tpu_torch.convert import to_jax_tree
    from transplat_tpu_torch.inference import init_random
    from transplat_tpu_torch.model.encoder import EncoderTranSplat

    monkeypatch.chdir(tmp_path)
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    seeded = EncoderTranSplat(load_config("re10k", yaml_path=tmp_path / "tiny.yaml").encoder, device="cpu")
    init_random(seeded, 17)
    np.save(tmp_path / "tree.npy", to_jax_tree(seeded), allow_pickle=True)
    np.save(tmp_path / "lpips.npy", lpips_state_dict("torchvision", seed=2), allow_pickle=True)
    index = tmp_path / "index.json"
    assert main(["generate-index", "--dataset-root", str(data_root), "--output", str(index), "--device", "cpu"]) == 0
    common = ["--config", "tiny.yaml", "--dataset-root", str(data_root), "--evaluation-index", str(index),
              "--device", "cpu", f"checkpointing.lpips_weights={tmp_path / 'lpips.npy'}"]
    out = tmp_path / "weights"
    assert main(["test", *common, "--output", str(out), "--save-image", f"checkpointing.pretrained_model={tmp_path / 'tree.npy'}",
                 "test.stage_timing=true", "test.analyze=true", "test.save_video=true", "test.save_ply=true"]) == 0
    printed = capsys.readouterr().out
    assert f"loaded pretrained weights: model={tmp_path / 'tree.npy'}" in printed and "lpips: weights from" in printed
    files = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
    for scene in ("te_0", "te_1"):
        for name in ("color/0000.png", "wobble.mp4", "interpolation.mp4", "gaussians.ply"):
            assert f"{scene}/{name}" in files
    for name in ("analysis_avg.json", "analysis_per_scene.json", "benchmark.json", "scores_all_avg.json",
                 "scores_per_scene.json"):
        assert name in files
    assert "encoder_4b_cost_volume_matching" in json.loads((out / "benchmark.json").read_text())["summary"]
    assert all(np.isfinite(s["lpips"]) for s in json.loads((out / "scores_per_scene.json").read_text()).values())
    # a second method: the seed-init weights of `test` without a weight file
    other = tmp_path / "seeded"
    assert main(["test", *common, "--output", str(other), "--save-image"]) == 0

    methods = ["--method", f"weights={out}", "--method", f"seeded={other}"]
    assert main(["compute-metrics", "--ground-truth", str(out), *methods, "--output", str(tmp_path / "m"),
                 "--device", "cpu"]) == 0
    ours = json.loads((tmp_path / "m" / "summary.json").read_text())
    assert ours["weights"]["psnr"] == pytest.approx(120.0)  # identical images: -10 log10(1e-12)
    assert ours["weights"]["ssim"] == pytest.approx(1.0) and "lpips" not in ours["weights"]  # no lpips_fn, as in JAX
    proc = jax_cli(["compute-metrics", "--ground-truth", str(out), *methods, "--output", str(tmp_path / "j")], tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    theirs = json.loads((tmp_path / "j" / "summary.json").read_text())
    assert sorted(ours) == sorted(theirs) == ["seeded", "weights"]
    for m in ours:
        assert sorted(ours[m]) == sorted(theirs[m]) == ["psnr", "ssim"]
        # SSIM's variances are differences of float32 filter sums: at 64x64 the two
        # packages' filters part by 1.9e-5 (measured), so 5e-5 here.
        assert abs(ours[m]["psnr"] - theirs[m]["psnr"]) < 1e-4 and abs(ours[m]["ssim"] - theirs[m]["ssim"]) < 5e-5


TRAIN_TINY = dict(encoder_cfg=tiny_encoder_cfg(), image_shape=(64, 64), inner=1, iters=1)
FIELDS = {"metric", "value", "unit", "vs_baseline", "bf16_tier_fwd_mpix_s", "train_step_ms", "chained_inner",
          "train_views", "train_batch", "device", "power_limit_w"}


def test_bench_main_prints_every_field_at_a_tiny_size(capsys, monkeypatch):
    assert bench.main(device="cpu", views=2, gaussians=256, image=32, inner=2, outer=1, train=True,
                      train_kwargs=TRAIN_TINY) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(record) == FIELDS
    assert record["metric"] == "rasterizer_fwd_bwd_throughput" and record["unit"] == "Mpix/s/chip"
    assert record["device"] == "cpu" and record["power_limit_w"] is None
    for k in ("value", "vs_baseline", "bf16_tier_fwd_mpix_s", "train_step_ms"):
        assert np.isfinite(record[k]) and record[k] > 0, k
    assert record["vs_baseline"] == pytest.approx(record["value"] / bench.BASELINE_MPIX_S)
    assert (record["chained_inner"], record["train_views"], record["train_batch"]) == (1, 4, 1)
    monkeypatch.setenv("TRANSPLAT_BENCH_TRAIN", "0")
    assert "train_step_ms" not in bench.run(device="cpu", views=1, gaussians=64, image=16, inner=1, outer=1)


def test_bench_scene_and_a_failing_train_step(monkeypatch):
    scene = bench.bench_scene(2, 4096, torch.device("cpu"), seed=0)
    m = scene["means"]
    assert m.shape == (2, 4096, 3) and scene["sh"].shape == (2, 4096, 3, 25)
    assert float(m[..., :2].abs().max()) <= 3.0 and 1.0 <= float(m[..., 2].min()) and float(m[..., 2].max()) <= 12.0
    scales = torch.diagonal(scene["covariances"], dim1=-2, dim2=-1).sqrt()
    assert 0.005 <= float(scales.min()) and float(scales.max()) <= 0.03
    assert torch.equal(scene["covariances"], torch.diag_embed(torch.diagonal(scene["covariances"], dim1=-2, dim2=-1)))
    assert 0.3 <= float(scene["opacities"].min()) and float(scene["opacities"].max()) <= 0.95
    assert abs(float(scene["sh"].std()) - 0.3) < 0.01
    assert torch.equal(scene["means"], bench.bench_scene(2, 4096, torch.device("cpu"), seed=0)["means"])

    def broken(*args, **kwargs):
        raise RuntimeError("a broken training step")

    # bench.py reports "train_step_ms": null for a failed step; the port's bench fails
    monkeypatch.setattr("transplat_tpu_torch.bench_train_step.build", broken)
    with pytest.raises(RuntimeError, match="broken training step"):
        bench.run(device="cpu", views=1, gaussians=64, image=16, inner=1, outer=1, train=True,
                  train_kwargs=TRAIN_TINY)


def test_view_overlap_matches_jax():
    """The port's view_overlap (and the ray test under it) within 1e-5 of the
    JAX package's, on pans, slides, a turned-away camera and a skewed focal."""
    import jax.numpy as jnp

    from transplat_tpu.geometry.overlap import view_overlap as jax_overlap
    from transplat_tpu_torch.dataset.re10k import convert_poses
    from transplat_tpu_torch.geometry.overlap import view_overlap

    poses = chunks.orbit_poses(200, yaw_deg_per_frame=0.9, slide_per_frame=0.05)
    poses[100:, 0] = 0.7  # another focal length for half the frames
    extr, intr = convert_poses(poses)
    pairs = [(0, 0), (0, 10), (0, 45), (10, 90), (0, 199), (199, 3), (60, 150)]
    for i, j in pairs:
        got = float(view_overlap(*(torch.from_numpy(a) for a in (extr[i], intr[i], extr[j], intr[j]))))
        want = float(jax_overlap(*(jnp.asarray(a) for a in (extr[i], intr[i], extr[j], intr[j]))))
        assert abs(got - want) <= 1e-5, (i, j, got, want)
    assert float(view_overlap(*(torch.from_numpy(a) for a in (extr[0], intr[0], extr[199], intr[199])))) < 0.2
