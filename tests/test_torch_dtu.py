"""DTU in the port: chunks of PNG frames, as scripts/convert_dtu.py writes
them, and the encoder at the 3 and 4 context views of the dtu_nctx3 /
dtu_nctx4 evaluation indices, each against the JAX package.

The chunks hold the raw bytes of PNG files (`rect_*_3_r5000.png`, 512x640 in
the published scans) and the 18-float pose rows convert_dtu.py builds
([fx / w, fy / h, 0.5, 0.5, 0, 0, world-to-camera 3x4]). Both readers decode
them with Pillow; the port reads their shape from the IHDR chunk.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_encoder import _tiny_cfgs
from test_torch_modules import random_variables
from transplat_tpu.dataset import re10k as jre10k
from transplat_tpu.dataset import view_samplers as jvs
from transplat_tpu_torch import native
from transplat_tpu_torch.config import DatasetCfg
from transplat_tpu_torch.dataset import chunks, re10k, view_samplers as vs

FRAMES = 6


def _png(frame: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    return buf.getvalue()


def dtu_scene(key: str, hw: tuple[int, int], seed: int) -> dict:
    return chunks.make_png_scene(key, FRAMES, seed, hw)


@pytest.fixture(scope="module")
def dtu_dir(tmp_path_factory):
    """test/: one chunk of two 512x640 scans (the published frames) and one
    360x640 scan (the dtu config's expected_shape)."""
    root = tmp_path_factory.mktemp("dtu_port")
    chunks.write_chunk(root / "test" / "000000.torch", [
        dtu_scene("scan1", (512, 640), 0), dtu_scene("scan8", (360, 640), 1), dtu_scene("scan21", (512, 640), 2),
    ])
    return root


def _samplers(kind: str, tmp_path):
    if kind == "all":
        return vs.ViewSamplerAll(), jvs.ViewSamplerAll()
    # dtu_nctx3-like: three context views and two targets per scan.
    index = {s: {"context": [0, 2, 4], "target": [1, 5]} for s in ("scan1", "scan8", "scan21")}
    path = tmp_path / "evaluation_index_dtu_nctx3.json"
    path.write_text(json.dumps(index))
    return vs.ViewSamplerEvaluation(path), jvs.ViewSamplerEvaluation(path)


@pytest.mark.parametrize("sampler", ["all", "nctx3"])
@pytest.mark.parametrize("skip_bad_shape", [False, True])
def test_dtu_png_chunks_match_jax(dtu_dir, tmp_path, sampler, skip_bad_shape):
    """Example by example: the same scenes (with the shape check only the
    360x640 scan), indices, cameras and bounds; images within 1/255 (both
    decode with Pillow and rescale with LANCZOS; measured equal)."""
    kw = dict(roots=[str(dtu_dir)], image_shape=(256, 256), test_times_per_scene=1, skip_bad_shape=skip_bad_shape)
    port_s, jax_s = _samplers(sampler, tmp_path)
    port = re10k.ChunkDataset(DatasetCfg(**kw), "test", port_s, seed=5)
    ref = jre10k.ChunkDataset(jre10k.DatasetCfg(**kw), "test", jax_s, seed=5)
    got, want = list(port), list(ref)
    assert [e["scene"] for e in got] == [e["scene"] for e in want]
    assert [e["scene"] for e in got] == (["scan8"] if skip_bad_shape else ["scan1", "scan8", "scan21"])
    for a, b in zip(got, want):
        for key in ("context", "target"):
            np.testing.assert_array_equal(a[key]["index"], b[key]["index"])
            assert a[key]["image"].dtype == np.float32 and a[key]["image"].shape[1:] == (256, 256, 3)
            np.testing.assert_allclose(a[key]["image"], b[key]["image"], rtol=0, atol=1 / 255)
            np.testing.assert_array_equal(a[key]["extrinsics"], b[key]["extrinsics"])
            np.testing.assert_allclose(a[key]["intrinsics"], b[key]["intrinsics"], rtol=0, atol=1e-6)
            for k in ("near", "far"):
                np.testing.assert_array_equal(a[key][k], b[key][k])


def test_png_header_shape_and_decode_match_pillow(dtu_dir):
    """The header's shape is the decoded one (the JAX check compares decoded
    shapes), and the decode equals Pillow's, for RGB, grey and RGBA PNGs."""
    scenes = torch.load(dtu_dir / "test" / "000000.torch", weights_only=False)
    blobs = [np.asarray(im).tobytes() for im in scenes[0]["images"][:2]]
    rng = np.random.default_rng(0)
    blobs.append(_png(rng.integers(0, 256, (512, 640), dtype=np.uint8)))
    blobs.append(_png(rng.integers(0, 256, (512, 640, 4), dtype=np.uint8)))
    for blob in blobs:
        want = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
        assert native.image_shape(blob) == want.shape[:2] == (512, 640)
        np.testing.assert_array_equal(native.decode_png_batch([blob])[0], want)
    jpeg = native.encode_jpeg_batch(np.zeros((1, 24, 40, 3), np.uint8))[0]
    assert native.image_shape(jpeg) == native.jpeg_shape(jpeg) == (24, 40)


def test_a_blob_of_neither_format_raises():
    for blob in (b"GIF89a" + bytes(32), b"\x89PNX\r\n\x1a\n" + bytes(32), b""):
        with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
            native.image_shape(blob)
        with pytest.raises(ValueError, match="not a JPEG"):
            re10k._decode_images([blob])
    with pytest.raises(ValueError, match="no IHDR"):
        native.png_shape(native.PNG_SIGNATURE + bytes(16))
    with pytest.raises(ValueError, match="not a PNG"):
        native.decode_png_batch([b"\xff\xd8" + bytes(16)])


@pytest.mark.parametrize("views", [3, 4])
def test_encoder_matches_jax_at_more_context_views(views):
    """EncoderTranSplat at 3 and 4 context views (dtu_nctx3 / dtu_nctx4) at
    the tiny configuration, weights through load_jax_variables: every
    Gaussian field within atol 1e-3 + rtol 1e-3, the bound of the 2-view
    test (tests/test_torch_encoder.py)."""
    import dataclasses

    from transplat_tpu.model.encoder import EncoderTranSplat as JEnc
    from transplat_tpu_torch.convert import load_jax_variables
    from transplat_tpu_torch.dataset import synthetic_batch
    from transplat_tpu_torch.model.encoder import EncoderTranSplat as TEnc

    jcfg, tcfg = _tiny_cfgs()
    jcfg = dataclasses.replace(jcfg, num_context_views=views)
    tcfg = dataclasses.replace(tcfg, num_context_views=views)
    batch = synthetic_batch(0, image_shape=(64, 64), num_context=views, num_target=2)
    ctx = [batch["context"][k] for k in ("image", "intrinsics", "extrinsics", "near", "far")]
    jm = JEnc(jcfg)
    variables = random_variables(jm, *ctx, seed=11)
    variables["params"]["depth_predictor"]["to_disparity_2"]["kernel"][..., 0] *= 0.01  # as the 2-view test
    port = TEnc(tcfg, device="cpu")
    load_jax_variables(port, variables)
    with torch.no_grad():
        g_t = port(*(torch.from_numpy(a) for a in ctx))
    g_j = jax.jit(jm.apply)(variables, *(jnp.asarray(a) for a in ctx))
    assert g_t.means.shape == (1, views * 64 * 64, 3)
    for name in ("means", "covariances", "harmonics", "opacities"):
        np.testing.assert_allclose(
            getattr(g_t, name).numpy(), np.asarray(getattr(g_j, name)), atol=1e-3, rtol=1e-3, err_msg=name
        )


@pytest.mark.parametrize("context", [[0, 4], [0, 2, 4]])
def test_main_test_runs_on_dtu_png_chunks(dtu_dir, tmp_path, monkeypatch, context):
    """`main test --experiment dtu` over the PNG chunk (seed-initialised tiny
    encoder, an evaluation index of every scan, 2 or 3 context views): the
    512x640 scans are skipped by the dtu config's shape check, the 360x640
    scan is scored."""
    from test_torch_cli import TINY_YAML
    from transplat_tpu_torch.main import main

    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        (tmp_path / "tiny.yaml").write_text(TINY_YAML)
        index = tmp_path / "evaluation_index_dtu.json"
        index.write_text(json.dumps({s: {"context": context, "target": [3]} for s in ("scan1", "scan8", "scan21")}))
        assert main(["test", "--experiment", "dtu", "--config", "tiny.yaml", "--dataset-root", str(dtu_dir),
                     "--evaluation-index", str(index), "--output", "scores", "--device", "cpu",
                     f"encoder.num_context_views={len(context)}"]) == 0
    finally:
        torch.set_num_threads(threads)
    per_scene = json.loads((tmp_path / "scores" / "scores_per_scene.json").read_text())
    assert sorted(per_scene) == ["scan8"]
    assert all(np.isfinite(per_scene["scan8"][k]) for k in ("psnr", "ssim", "lpips"))
