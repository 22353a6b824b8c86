"""The whole slice, port vs JAX package: EncoderTranSplat + decode_splatting at
the tiny configuration of __graft_entry__.py (2 context views at 64x64,
2 target views), weights through `load_jax_variables`; plus the weight
loader's errors and the port's import hygiene.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modules import random_variables
from transplat_tpu_torch.convert import load_jax_variables

ROOT = Path(__file__).resolve().parents[1]


def _tiny_cfgs():
    from transplat_tpu.model.adapter import GaussianAdapterCfg as JA
    from transplat_tpu.model.encoder import EncoderCfg as JE
    from transplat_tpu_torch.model.adapter import GaussianAdapterCfg as TA
    from transplat_tpu_torch.model.encoder import EncoderCfg as TE

    kw = dict(
        d_feature=16, num_depth_candidates=16, costvolume_unet_feat_dim=16, costvolume_unet_channel_mult=(1, 1),
        costvolume_unet_attn_res=(2,), depth_unet_feat_dim=8, depth_unet_attn_res=(4,),
        depth_unet_channel_mult=(1, 1, 1), dav2_encoder="vits", dav2_input_size=28,
    )
    return JE(**kw, gaussian_adapter=JA(sh_degree=1)), TE(**kw, gaussian_adapter=TA(sh_degree=1))


@pytest.fixture(scope="module")
def slice_pair():
    from transplat_tpu.model.encoder import EncoderTranSplat as JEnc
    from transplat_tpu_torch.dataset import synthetic_batch
    from transplat_tpu_torch.model.encoder import EncoderTranSplat as TEnc

    jcfg, tcfg = _tiny_cfgs()
    batch = synthetic_batch(0, image_shape=(64, 64), num_target=2)
    ctx = [batch["context"][k] for k in ("image", "intrinsics", "extrinsics", "near", "far")]
    jm = JEnc(jcfg)
    variables = random_variables(jm, *ctx, seed=11)
    # Random heads put many disparities at the 1/far clip, where depth =
    # 1/disparity turns a 1e-5 disparity difference into 1e-3 of depth;
    # damping the disparity-delta channel keeps depths in 1.5..10.
    variables["params"]["depth_predictor"]["to_disparity_2"]["kernel"][..., 0] *= 0.01
    port = TEnc(tcfg, device="cpu")
    load_jax_variables(port, variables)
    return jm, port, variables, batch, ctx


def test_encoder_and_decoder_match_jax(slice_pair):
    from transplat_tpu.model.decoder import DecoderCfg as JDC
    from transplat_tpu.model.decoder import decode_splatting as jdecode
    from transplat_tpu.ops.rasterizer.api import RasterizeConfig as JRC
    from transplat_tpu_torch.inference import render_novel_views

    jm, port, variables, batch, ctx = slice_pair
    with torch.no_grad():
        g_t = port(*(torch.from_numpy(a) for a in ctx))
    g_j = jax.jit(jm.apply)(variables, *(jnp.asarray(a) for a in ctx))  # jit: 4x faster than op by op here
    # Backbone, DAv2, matching, two U-Nets and the adapter compound float32
    # reassociation; Gaussians agree to 1e-3 absolute + relative.
    for name in ("means", "covariances", "harmonics", "opacities"):
        np.testing.assert_allclose(
            getattr(g_t, name).numpy(), np.asarray(getattr(g_j, name)), atol=1e-3, rtol=1e-3, err_msg=name
        )

    tgt = batch["target"]
    cams = [tgt[k] for k in ("extrinsics", "intrinsics", "near", "far")]
    out_j = jdecode(
        g_j, *(jnp.asarray(a) for a in cams), (64, 64),
        cfg=JDC(rasterize=JRC(mode="tiled", binning="fast", capacity=4096, chunk=128)),
    )
    assert int(np.asarray(out_j.overflow).sum()) == 0
    colors = render_novel_views(port, batch["context"], tgt, (64, 64), device="cpu")
    assert colors.shape == (1, 2, 64, 64, 3) and bool(torch.isfinite(colors).all())
    # The same Gaussians rendered by both packages (the port's plain tiled
    # path on the CPU), each projecting them itself: 99.9% of colour values
    # within 1e-5. The rest sit where an ulp of projection rounding flips the
    # integer cutoff radius or the 1/255 alpha floor (see below).
    from transplat_tpu_torch.model.decoder import decode_splatting
    from transplat_tpu_torch.model.types import Gaussians

    same = decode_splatting(
        Gaussians(*(torch.from_numpy(np.array(x)) for x in g_j)), *(torch.from_numpy(a) for a in cams), (64, 64)
    )
    same_diff = np.abs(same.color.numpy() - np.asarray(out_j.color))
    assert np.mean(same_diff > 1e-5) < 1e-3 and same_diff.max() < 0.05, (np.mean(same_diff > 1e-5), same_diff.max())
    # End to end, each package renders its own Gaussians, which differ by
    # float32 reassociation (above). The renderer is discontinuous there:
    # the cutoff radius ceil(3 sqrt(lambda_max)) is an integer and the
    # 1/255 alpha floor a step, so a 1e-4 relative change of a covariance
    # can add or drop a ring of alpha ~0.01-0.03 pixels. Measured: ~1.5% of
    # values beyond 1e-4, none beyond 0.03. Bound: 98% within 1e-4, all
    # within 0.05.
    diff = np.abs(colors.numpy() - np.asarray(out_j.color))
    assert np.mean(diff > 1e-4) < 0.02, np.mean(diff > 1e-4)
    assert diff.max() < 0.05, diff.max()


def test_load_jax_variables_rejects_missing_and_extra(slice_pair):
    import copy

    from transplat_tpu_torch.model.encoder import EncoderTranSplat as TEnc

    _, _, variables, _, _ = slice_pair
    _, tcfg = _tiny_cfgs()
    missing = copy.deepcopy(variables)
    del missing["params"]["depth_predictor"]["corr_conv_in"]["bias"]
    with pytest.raises(KeyError, match="corr_conv_in"):
        load_jax_variables(TEnc(tcfg, device="cpu"), missing)
    extra = copy.deepcopy(variables)
    extra["params"]["backbone"]["unused_dense"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unused_dense"):
        load_jax_variables(TEnc(tcfg, device="cpu"), extra)
    wrong = copy.deepcopy(variables)
    wrong["batch_stats"]["backbone"]["cam_param_encoder"]["bn"]["mean"] = np.zeros((17,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(TEnc(tcfg, device="cpu"), wrong)


def test_port_imports_nothing_of_jax():
    code = (
        "import importlib, pkgutil, sys, transplat_tpu_torch\n"
        "for m in pkgutil.walk_packages(transplat_tpu_torch.__path__, 'transplat_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'transplat_tpu')]\n"
        "print(bad)\n"
        "print(' '.join(m for m in sys.modules if m.startswith('transplat_tpu_torch')))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    imported = set(proc.stdout.splitlines()[-1].split())
    # The data path, the command line and the bench are among the modules checked.
    for name in ("dataset.types", "dataset.view_samplers", "dataset.shims", "dataset.re10k", "dataset.chunks",
                 "native", "geometry.overlap", "evaluation.index_generator", "main", "bench", "bench_train_step",
                 "training.pretrained", "evaluation.staged", "evaluation.metric_computer", "utils.analysis",
                 "utils.image_io", "visualization.ply_export", "visualization.trajectory", "visualization.layout",
                 "visualization.validation_3d", "convert.common", "convert.backbone", "convert.dav2", "convert.unet",
                 "convert.uv", "convert.depth_predictor", "convert.encoder", "convert_weights", "parallel.mesh",
                 "parallel.launch", "parallel.dryrun", "tools.test_splatter", "tools.visualize_epipolar_lines"):
        assert f"transplat_tpu_torch.{name}" in imported, name
    files = sorted((ROOT / "transplat_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                mods = {w.split(".")[0] for w in words[1:] if w not in ("import", "as")}
                assert not mods & {"jax", "jaxlib", "flax", "transplat_tpu"}, f"{path}: {line}"
