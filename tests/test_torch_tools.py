"""The port's two reference tools (transplat_tpu_torch/tools) on the CPU,
each against the JAX package's script on the same inputs."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from transplat_tpu.geometry import epipolar as jax_epipolar
from transplat_tpu.geometry.projection import unnormalize_intrinsics as jax_unnormalize
from transplat_tpu_torch.dataset import chunks
from transplat_tpu_torch.tools import test_splatter as splatter
from transplat_tpu_torch.tools import visualize_epipolar_lines as epilines
from transplat_tpu_torch.utils.image_io import load_video, to_uint8

ROOT = Path(__file__).resolve().parents[1]


def jax_script(name: str, args: list[str], cwd: Path) -> subprocess.CompletedProcess:
    env = {"PYTHONPATH": str(ROOT), "PATH": os.environ.get("PATH", "/usr/bin:/bin"), "JAX_PLATFORMS": "cpu",
           "HOME": str(cwd)}
    return subprocess.run([sys.executable, str(ROOT / "scripts" / name), *args], capture_output=True, text=True,
                          cwd=str(cwd), env=env, timeout=600)


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path))


def test_splatter_writes_frames_and_video_equal_to_render_and_jax(tmp_path):
    """4 frames at 64^2 and a 4-frame mp4; frame 0 is `render` of the same
    Gaussians from the spin's first camera alone; every PNG equals the JAX
    script's byte for byte in pixels (measured: equal)."""
    out = tmp_path / "port"
    assert splatter.main(["--device", "cpu", "--frames", "4", "--resolution", "64", "--output", str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == [f"frame_{i:03d}.png" for i in range(4)] + ["spin.mp4"]
    assert load_video(out / "spin.mp4").shape == (4, 64, 64, 3)

    gaussians = splatter.random_gaussians(8, "cpu")
    cams = [c[:1] for c in splatter.spin_cameras(4, "cpu")]
    from transplat_tpu_torch.ops.rasterizer.api import render

    with torch.no_grad():
        first = render(*cams, (64, 64), torch.zeros(1, 3), *gaussians, scale_invariant=False).color[0]
    np.testing.assert_array_equal(_png(out / "frame_000.png"), to_uint8(first.clamp(0, 1).numpy()))

    proc = jax_script("test_splatter.py", ["--frames", "4", "--resolution", "64", "--output", str(tmp_path / "jax")],
                      tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for i in range(4):
        np.testing.assert_array_equal(_png(out / f"frame_{i:03d}.png"), _png(tmp_path / "jax" / f"frame_{i:03d}.png"))


def test_splatter_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        splatter.main(["--frames", "1"])


@pytest.fixture(scope="module")
def epipolar_root(tmp_path_factory):
    """datasets/re10k/test/: one seeded 60-frame scene at 360x640 (where the
    JAX script looks by default), and an index naming its views."""
    root = tmp_path_factory.mktemp("epipolar")
    chunks.write_chunk(root / "datasets" / "re10k" / "test" / "000000.torch", [chunks.make_scene("ep_0", 60, seed=3)])
    (root / "index.json").write_text(json.dumps({"ep_0": {"context": [5, 40], "target": [20]}}))
    return root


def test_epipolar_lines_image_and_samples_match_jax(epipolar_root, tmp_path):
    """The tool's PNG equals the JAX script's (pixel for pixel, measured
    equal), and its sample points equal JAX's epipolar_sample_grid on the
    same context within 1e-5 (in [0, 1] units)."""
    out = tmp_path / "port"
    args = ["--device", "cpu", "--dataset-root", str(epipolar_root / "datasets" / "re10k"), "--evaluation-index",
            str(epipolar_root / "index.json"), "--out", str(out), "--max-scenes", "1"]
    assert epilines.main(args) == 0
    image = _png(out / "ep_0.png")
    assert image.shape == (256, 2 * 256 + 8, 3)
    proc = jax_script("visualize_epipolar_lines.py", ["--evaluation-index", str(epipolar_root / "index.json"),
                                                      "--out", str(tmp_path / "jax"), "--max-scenes", "1"], epipolar_root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    np.testing.assert_array_equal(image, _png(tmp_path / "jax" / "ep_0.png"))

    from transplat_tpu_torch.config import DatasetCfg
    from transplat_tpu_torch.dataset.re10k import ChunkDataset
    from transplat_tpu_torch.dataset.view_samplers import ViewSamplerEvaluation

    ds = ChunkDataset(DatasetCfg(roots=[str(epipolar_root / "datasets" / "re10k")]), "test",
                      ViewSamplerEvaluation(epipolar_root / "index.json"))
    ctx = next(iter(ds))["context"]
    grid = epilines.sample_grid(ctx, 32, "cpu")
    h, w = ctx["image"].shape[1:3]
    want = jax_epipolar.epipolar_sample_grid(
        jax_unnormalize(jnp.asarray(ctx["intrinsics"][0]), (h, w)),
        jax_epipolar.relative_pose(jnp.asarray(ctx["extrinsics"][0]), jnp.asarray(ctx["extrinsics"][1])),
        1.0 / jax_epipolar.inverse_depth_candidates(jnp.asarray(ctx["near"][0]), jnp.asarray(ctx["far"][0]), 32), h, w)
    assert grid.shape == (32, h * w, 2)
    np.testing.assert_allclose(grid, np.asarray(want), rtol=0, atol=1e-5)
