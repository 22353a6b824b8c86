"""The port's stage and memory tooling against the JAX package's, on the
CPU at the tiny configuration of __graft_entry__.py.

- The small helpers: `geometry.num_sh_coeffs`, `covariance_upper_triangle`
  and its inverse, `native.available`; `device_memory_stats` ({} on the
  CPU) and the JSON of `Benchmarker.dump_memory` / `dump` in JAX's schema.
- The sub-graphs that `bench_dp_stages` times against those that
  scripts/bench_dp_stages.py builds, from one set of JAX variables on the
  port's seeded numpy inputs (tolerances of tests/test_torch_stage_benches.py,
  which holds the encoder's and the training step's sub-graphs).
- `profile_stages`'s stage_profile.json read by scripts/analyze_hbm_share.py
  unchanged; `bench_dataloader`'s chunks read alike by both packages'
  ChunkDataset; `tools/analyze_sampling_locality` equal to the JAX script
  within SAMPLING_TOL; each tool's refusal to run without a card unless
  asked for the CPU.
"""

import json
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_stage_benches import (  # noqa: F401  (weights and one_torch_thread are fixtures)
    SHAPE,
    assert_grads_close,
    assert_outputs_close,
    jax_depth_predictor,
    lazy,
    one_torch_thread,
    outputs_and_grad,
    port_grads,
    weights,
)
from test_torch_training import flat
from transplat_tpu_torch import bench_dp_stages

ROOT = Path(__file__).resolve().parents[1]
SAMPLING_TOL = 1e-6


# ---------------------------------------------------------------------------
# the small helpers and the Benchmarker's JSON
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_num_sh_coeffs_matches_jax(degree):
    from transplat_tpu.geometry import num_sh_coeffs as jax_num
    from transplat_tpu_torch.geometry import num_sh_coeffs

    assert num_sh_coeffs(degree) == jax_num(degree)


def test_covariance_upper_triangle_round_trip_matches_jax():
    from transplat_tpu.geometry.gaussians import covariance_from_upper_triangle as jax_unpack
    from transplat_tpu.geometry.gaussians import covariance_upper_triangle as jax_pack
    from transplat_tpu_torch.geometry import covariance_from_upper_triangle, covariance_upper_triangle

    a = np.random.default_rng(0).standard_normal((2, 5, 3, 3)).astype(np.float32)
    cov = a @ np.swapaxes(a, -1, -2)
    packed = covariance_upper_triangle(torch.from_numpy(cov))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack(jnp.asarray(cov))))
    np.testing.assert_array_equal(covariance_from_upper_triangle(packed).numpy(),
                                  np.asarray(jax_unpack(jnp.asarray(packed.numpy()))))
    np.testing.assert_array_equal(covariance_from_upper_triangle(packed).numpy(), cov)


def test_native_available_matches_jax():
    from transplat_tpu import native as jax_native
    from transplat_tpu_torch import native

    assert native.available() and jax_native.available()


def test_device_memory_stats_is_empty_on_the_cpu():
    from transplat_tpu_torch.utils.benchmarker import Benchmarker, device_memory_stats

    assert device_memory_stats("cpu") == {}
    bench = Benchmarker("cpu")
    with bench.memory("stage"):
        pass
    assert bench.memory_stats == {"stage": {}}


def test_dump_memory_and_dump_have_jax_keys(tmp_path):
    """Both packages' Benchmarker, the same stages on the CPU: the same keys
    in peak_memory.json (`extra` merged in) and in the timing dump."""
    from transplat_tpu.utils.benchmarker import Benchmarker as JaxBenchmarker
    from transplat_tpu_torch.utils.benchmarker import Benchmarker

    dumps = {}
    for name, bench in (("jax", JaxBenchmarker()), ("port", Benchmarker("cpu"))):
        for tag in ("encoder", "decoder"):
            with bench.memory(tag), bench.time(tag):
                pass
            with bench.time_blocking(tag) as out:
                out["result"] = jnp.zeros(1) if name == "jax" else torch.zeros(1)
        bench.dump_memory(tmp_path / name / "peak_memory.json", extra={"compiled": {}})
        bench.dump(tmp_path / name / "timing.json")
        dumps[name] = [json.loads((tmp_path / name / f).read_text()) for f in ("peak_memory.json", "timing.json")]
    (jmem, jtime), (mem, timing) = dumps["jax"], dumps["port"]
    assert mem == jmem == {"device": {}, "stages": {"encoder": {}, "decoder": {}}, "compiled": {}}
    assert set(timing) == set(jtime) == {"summary", "raw"}
    assert timing["summary"].keys() == jtime["summary"].keys()
    assert all(timing["summary"][t].keys() == jtime["summary"][t].keys() for t in jtime["summary"])
    assert all(s["count"] == 2 for s in timing["summary"].values())


# ---------------------------------------------------------------------------
# bench_dp_stages
# ---------------------------------------------------------------------------


def _jax_dp_rows(w, x) -> dict:
    """scripts/bench_dp_stages.py's sub-graphs on the port's numpy inputs `x`."""
    from transplat_tpu.model.depth_predictor import DepthPredictor

    cfg, variables = w["jcfg"], w["variables"]
    images, intrinsics, extrinsics, near, far = w["ctx"]
    h, wd = images.shape[2:4]
    features, cnn, da_depth, dino = (jnp.asarray(x[k]) for k in ("features", "cnn_features", "da_depth",
                                                                   "dino_feature"))
    hf, wf = features.shape[2:4]
    dp = jax_depth_predictor(cfg)
    dp_vars = {"params": variables["params"]["depth_predictor"],
               "batch_stats": variables["batch_stats"].get("depth_predictor", {})}

    def stage(method, *xs):
        return outputs_and_grad(lambda vs: dp.apply(vs, *xs, method=method))(dp_vars)

    def compute():
        prep = jax.jit(lambda: dp.apply(dp_vars, features, intrinsics, extrinsics, near, far, dino,
                                        method=DepthPredictor.prep))()
        corr, matching_grad = stage(DepthPredictor.matching, prep, (hf, wf))
        raw_corr, cost_grad = stage(DepthPredictor.cost_unet, corr, features)
        coarse = jax.jit(lambda: dp.apply(dp_vars, raw_corr, prep["disp_candidates"], (h, wd),
                                          method=DepthPredictor.coarse_depth))()
        (refine_out, proj), refine_grad = stage(DepthPredictor.refine, features, cnn, images, da_depth, coarse)
        _, heads_grad = stage(DepthPredictor.heads, refine_out, proj, images, coarse["fullres_disps"], near, far)
        return dict(zip(bench_dp_stages.ROWS, (corr, matching_grad["params"], cost_grad["params"],
                                               (refine_out, proj), refine_grad["params"], heads_grad["params"])))

    row = lazy(compute)
    return {name: row(name) for name in bench_dp_stages.ROWS}


@pytest.fixture(scope="module")
def dp_rows(weights):
    port_rows = bench_dp_stages.subgraphs(weights["port"], weights["batch"], "cpu")
    return port_rows, _jax_dp_rows(weights, bench_dp_stages.inputs(weights["port"].cfg, SHAPE))


@pytest.mark.parametrize("row", bench_dp_stages.ROWS)
def test_depth_predictor_subgraph_matches_jax(row, weights, dp_rows):
    port_rows, jax_rows = dp_rows
    got, ref = port_rows[row](), jax_rows[row]()
    if row.endswith("fwd+bwd"):
        assert_grads_close(port_grads(weights["port"], got, "depth_predictor"), flat(ref), row)
    elif row == "4e refine fwd":  # the port's stage returns NCHW
        assert_outputs_close([t.permute(0, 2, 3, 1) for t in got], list(ref), row)
    else:
        assert_outputs_close([got], [ref], row)


def test_dp_stages_refuses_s2d():
    with pytest.raises(SystemExit):
        bench_dp_stages.main(["--s2d", "--device", "cpu"])


# ---------------------------------------------------------------------------
# profile_stages -> analyze_hbm_share, the loader's chunks, the sampling locality
# ---------------------------------------------------------------------------


def test_analyze_hbm_share_reads_the_ports_stage_profile(tmp_path, capsys):
    """A tiny CPU profile (32x32, one timed run) in JAX's schema: every stage
    and the decoder, FLOPs where the JAX profile has them, bytes everywhere;
    scripts/analyze_hbm_share.py, unchanged, sums it into its four phases."""
    from transplat_tpu_torch import profile_stages
    from transplat_tpu_torch.evaluation.staged import STAGES

    assert profile_stages.main(["--tiny", "--iters", "1", "--device", "cpu", "--out",
                                str(tmp_path / "stage_profile.json")]) == 0
    profile = json.loads((tmp_path / "stage_profile.json").read_text())
    assert profile["device"] == "cpu" and [r["stage"] for r in profile["rows"]] == [*STAGES, "decoder"]
    keys = {"stage", "mean_ms", "real_ms", "gb_accessed", "gb_per_s", "gflop", "gflop_per_s"}
    assert all(keys <= set(r) for r in profile["rows"])
    rows = {r["stage"]: r for r in profile["rows"]}
    assert rows["encoder_2_backbone"]["gflop"] > 0 and all(r["gb_accessed"] > 0 for r in profile["rows"])
    assert all(r["launches"] == {} and r["kernel_gb"] == 0 for r in profile["rows"])  # plain versions on the CPU
    memory = json.loads((tmp_path / "peak_memory.json").read_text())
    assert memory["device"] == {} and list(memory["stages"]) == [*STAGES, "decoder"]
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "analyze_hbm_share.py"),
                           str(tmp_path / "stage_profile.json"), "--out", str(tmp_path / "share.json")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    share = json.loads((tmp_path / "share.json").read_text())
    assert share["total_gb_accessed"] == pytest.approx(sum(r["gb_accessed"] for r in profile["rows"]))
    assert sum(p["hbm_share"] for p in share["phases"].values()) == pytest.approx(1.0)


def test_bench_dataloader_chunks_read_alike_in_both_packages(tmp_path):
    """The bench's chunks (the port's writer, small frames) through both
    packages' ChunkDataset: the same scenes, views, images and cameras."""
    from transplat_tpu.dataset.re10k import ChunkDataset as JaxChunkDataset
    from transplat_tpu.dataset.re10k import DatasetCfg as JaxDatasetCfg
    from transplat_tpu.dataset.view_samplers import BoundedCfg as JaxBoundedCfg
    from transplat_tpu.dataset.view_samplers import ViewSamplerBounded as JaxBounded
    from transplat_tpu_torch import bench_dataloader
    from transplat_tpu_torch.config import BoundedCfg, DatasetCfg
    from transplat_tpu_torch.dataset.re10k import ChunkDataset
    from transplat_tpu_torch.dataset.view_samplers import ViewSamplerBounded

    hw = (72, 128)
    bench_dataloader.write_chunks(tmp_path, chunks=2, scenes=2, frames=40, hw=hw)
    port = ChunkDataset(DatasetCfg(roots=[str(tmp_path)], image_shape=(64, 64), expected_shape=hw), "train",
                        ViewSamplerBounded(BoundedCfg()))
    ref = JaxChunkDataset(JaxDatasetCfg(roots=[str(tmp_path)], image_shape=(64, 64), expected_shape=hw), "train",
                          JaxBounded(JaxBoundedCfg()))
    got, want = list(port.iter_examples(lambda: 0)), list(ref.iter_examples(lambda: 0))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a["scene"] == b["scene"]
        for side in ("context", "target"):
            for k in ("image", "extrinsics", "intrinsics", "near", "far", "index"):
                np.testing.assert_array_equal(np.asarray(a[side][k]), np.asarray(b[side][k]), err_msg=f"{side} {k}")


def test_bench_dataloader_needs_a_budget_and_measures_each_loader(capsys):
    from transplat_tpu_torch import bench_dataloader

    with pytest.raises(SystemExit):
        bench_dataloader.main(["--device", "cpu"])  # --step-ms has no default
    result = bench_dataloader.run(250.0, torch.device("cpu"), chunks=2, measure_batches=2, workers=(2,), frames=30)
    assert set(result["examples_per_s"]) == {"threaded", "workers_2"}
    assert all(r > 0 for r in result["examples_per_s"].values()) and result["need_examples_per_s"] == 8.0


def test_sampling_locality_matches_the_jax_script(tmp_path):
    from transplat_tpu_torch.tools import analyze_sampling_locality

    out = tmp_path / "port.json"
    assert analyze_sampling_locality.main(["--device", "cpu", "--out", str(out)]) == 0
    argv = sys.argv
    sys.argv = ["analyze_sampling_locality.py", "--out", str(tmp_path / "jax.json")]
    try:
        runpy.run_path(str(ROOT / "scripts" / "analyze_sampling_locality.py"), run_name="__main__")
    finally:
        sys.argv = argv
    got, want = (flat(json.loads(p.read_text())) for p in (out, tmp_path / "jax.json"))
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= SAMPLING_TOL * max(1.0, abs(float(want[k]))), (k, got[k], want[k])


@pytest.mark.parametrize("module", ["profile_stages", "bench_encoder_stages", "bench_dp_stages",
                                    "bench_train_stages", "bench_dataloader"])
def test_tools_exit_without_a_card_unless_asked_for_the_cpu(module):
    """Without --device cpu each tool needs the card; here there is none."""
    import importlib

    argv = ["--step-ms", "100"] if module == "bench_dataloader" else []
    with pytest.raises(SystemExit, match="no CUDA card"):
        importlib.import_module(f"transplat_tpu_torch.{module}").main(argv)
