"""pixelSplat's encoder in the port (transplat_tpu_torch/model/encoder_epipolar.py)
against the benchmark's plain reference (benchmark/reference/model/epipolar.py),
stage by stage and end to end, on the CPU at 64^2 and 2 views with the
published widths (ResNet-50, DINO ViT-B/8, the epipolar transformer) and one
set of seeded weights (benchmark/harness/weights.py). Also: the Gaussian
adapter stage at three Gaussians a pixel, and at one as it was; DAv2 vitl's
depth and layers; `project_rays` against a dense march along each ray; the
encoder's spans and counters. The adapter kernel at three Gaussians a pixel
runs on a card only (marker `cuda`).

Tolerances (relative L2 gaps unless a line says otherwise): the port and
the reference run the same float32 operations, the port with its attention
reassociated (module docstring of encoder_epipolar.py) and the sampler's
geometry through other formulas in float64, so they part by rounding:
1e-5 leaves ~10x room over the largest gap read here (~1e-6) and is ~100x
under what bfloat16 compute would give (~4e-3 a product).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from benchmark.harness.traffic import load as load_traffic
from benchmark.harness.traffic import make_scenes
from benchmark.harness.weights import load_parameters, seeded_parameters
from benchmark.reference.model import epipolar as ref_module
from transplat_tpu_torch import kernels
from transplat_tpu_torch.model import build_encoder
from transplat_tpu_torch.model.encoder import adapt_stage, adapt_stage_plain
from transplat_tpu_torch.model.encoder_epipolar import STAGES, EncoderEpipolar, EncoderEpipolarCfg
from transplat_tpu_torch.utils import trace

CPU = torch.device("cpu")
CONTEXT = ("image", "intrinsics", "extrinsics", "near", "far")
# The same float32 operations in another order (see the module docstring).
TOL = 1e-5
SEED = 2**31 + 19


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def models():
    """(port, reference) on the CPU with one set of seeded weights."""
    torch.set_num_threads(4)
    with torch.device("meta"):
        meta = ref_module.EncoderEpipolar(device="meta")
    weights = seeded_parameters(meta, SEED, CPU)
    port = build_encoder(EncoderEpipolarCfg(), device="cpu")
    reference = ref_module.EncoderEpipolar(device="cpu")
    load_parameters(port, weights)
    load_parameters(reference, weights)
    return port, reference


@pytest.fixture(scope="module")
def scene():
    """A request of the serving cell at 64^2: two context views of a
    forward-moving camera (scene 4 of the seed: 64 of its 512 low-grid rays
    miss the other view)."""
    config = {"encoder": {"num_context_views": 2}, "image_shape": [64, 64], "dataset": {"near": 1.0, "far": 100.0}}
    ctx = make_scenes(load_traffic("pixelsplat-re10k-index"), config, SEED, CPU, count=5)[4].context
    return [ctx[k] for k in CONTEXT]


def _image(images):
    b, v, h, w, _ = images.shape
    return images.permute(0, 1, 4, 2, 3).reshape(b * v, 3, h, w)


@torch.no_grad()
def test_backbone_matches_the_reference(models, scene):
    port, reference = models
    image = _image(scene[0])
    got = port.projection(torch.relu(port.backbone(image)))
    assert got.shape == (2, 64, 64, 128)
    assert rel(got, reference.features(image)) <= TOL


@torch.no_grad()
def test_sampler_matches_the_reference(models, scene):
    """Stage 2 on the reference's features: the rays' own features and their
    32 samples with the depth encodings; some rays of these cameras miss the
    other image, and every one that meets it agrees."""
    port, reference = models
    images, intr, extr, near, far = scene
    low = port.epipolar.downscaler(reference.features(_image(images)).permute(0, 3, 1, 2))
    trace.reset_counters()
    x, z = port.epipolar.sample(low, extr, intr, near, far)
    rx, rz, valid = reference.epipolar.sample(low, extr, intr, near, far)
    assert z.shape == (2 * 16 * 16, 32, 128)
    assert rel(x, rx) == 0.0 and rel(z, rz) <= TOL
    c = trace.counters()
    assert c["epipolar.rays"] == valid.numel() and c["epipolar.rays_on_image"] == int(valid.sum())
    assert 0 < int(valid.sum()) < valid.numel()


@torch.no_grad()
def test_attention_matches_the_reference(models):
    """Stage 3 (the epipolar attention reassociated in the port, the
    ConvFeedForward with its image self-attention) on the same rays and
    samples, over a 2 x 16 x 16 grid of rays."""
    port, reference = models
    gen = torch.Generator().manual_seed(3)
    n = 2 * 16 * 16
    x, z = torch.randn(n, 128, generator=gen), torch.randn(n, 32, 128, generator=gen)
    got = port.epipolar.attend(x, z, (2, 16, 16))
    assert rel(got, reference.epipolar.attend(x, z, (2, 16, 16))) <= TOL
    # The feed-forward's image self-attention and convolutions each move the rays.
    ff = port.epipolar.layers[0].ff
    f = torch.randn(2, 128, 16, 16, generator=gen)
    assert rel(ff.self_attention(f), reference.epipolar.layers[0].ff.self_attention(f)) <= TOL
    assert float(ff.self_attention(f).std()) > 0.1 * float(ff.conv_2(F.gelu(ff.conv_1(f))).std())


@torch.no_grad()
def test_upscale_and_depth_stages_match_the_reference(models, scene):
    """Stages 4 and 5: the heads' input, the three picks a pixel (exactly),
    their depths and densities, the raw channels."""
    port, reference = models
    images, intr, extr, near, far = scene
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2 * 16 * 16, 128, generator=gen)
    image = _image(images)
    y = port.epipolar.upscale(x, (2, 16, 16))
    y = torch.relu(y + torch.relu(port.skip(image))).permute(0, 2, 3, 1)
    ry = reference.head_input(x, image, (2, 16, 16))
    assert rel(y, ry) <= TOL
    f = ry.reshape(1, 2, 64, 64, 128)
    depth, density, got_picks, _ = port.depths(f, near, far)
    rdepth, rdensity, picks, raw = reference.depths(f, near, far)
    assert torch.equal(got_picks, picks)
    assert rel(depth, rdepth) <= TOL and rel(density, rdensity) <= TOL
    assert bool(((depth >= 1.0) & (depth <= 100.0)).all())


@torch.no_grad()
def test_encoder_gaussians_match_the_reference(models, scene):
    """The whole encoder: 3 Gaussians a pixel, (view, pixel, sample) order,
    every field within TOL and every pixel's picks the reference's."""
    port, reference = models
    got = port(*scene)
    want, picks, top = reference(*scene, return_picks=True)
    assert got.means.shape == (1, 2 * 64 * 64 * 3, 3) and got.harmonics.shape == (1, 2 * 64 * 64 * 3, 3, 25)
    assert picks.shape == (1, 2, 64 * 64, 3) and top.shape == (1, 2, 64 * 64, 4)
    for a, b in zip(got, want):
        assert rel(a, b) <= TOL
    assert float(got.opacities.sum()) == pytest.approx(float(want.opacities.sum()), rel=TOL)


@torch.no_grad()
def test_adapter_stage_at_three_gaussians_a_pixel_matches_the_reference(models):
    """The shared adapter stage at gpp = 3 (plain, on the CPU) against the
    reference's own adapter over each (pixel, sample)."""
    from _torch_cases import adapter_case

    _, reference = models
    cfg, (extr, intr, raw, depth, density, step, shape) = adapter_case(CPU, 1, 2, (8, 8), 4, 0, seed=5, samples=3)
    cfg = dataclasses.replace(cfg, opacity_mapping=EncoderEpipolarCfg().opacity_mapping)
    got = adapt_stage(cfg, extr, intr, raw, depth, density, step, shape)
    want = reference.gaussians(raw, depth, density, extr, intr, shape)
    for k, w in zip(("means", "covariances", "harmonics", "opacities"), want):
        assert got[k].shape == w.shape
        assert rel(got[k], w) <= 1e-6, k  # one adapter's float32 arithmetic, other shapes of the same ops


def test_adapter_stage_at_one_gaussian_a_pixel_is_the_stage_as_it_was():
    """At s = 1 the plain stage gives the bits the stage gave before it took
    samples: the pixel grid plus the offsets, the opacity curve over
    gaussians_per_pixel, `adapt_gaussians` on (b, v, r) tensors."""
    from _torch_cases import adapter_case
    from transplat_tpu_torch.geometry.projection import sample_image_grid
    from transplat_tpu_torch.model.adapter import adapt_gaussians
    from transplat_tpu_torch.model.encoder import map_pdf_to_opacity

    cfg, (extr, intr, raw, depth, density, step, (h, w)) = adapter_case(CPU, 2, 2, (5, 7), 4, 3, seed=6)
    got = adapt_stage_plain(cfg, extr, intr, raw, depth, density, step, (h, w), with_aux=True)
    d, p = depth[..., 0], density[..., 0]
    b, v, r = d.shape
    xy = sample_image_grid((h, w))[0].reshape(1, 1, r, 2)
    coords = xy + (torch.sigmoid(raw[..., :2]) - 0.5) * torch.tensor([1.0 / w, 1.0 / h])
    opac = map_pdf_to_opacity(p, cfg.opacity_mapping, step) / cfg.gaussians_per_pixel
    want = adapt_gaussians(cfg.gaussian_adapter, extr, intr, coords, d, opac, raw[..., 2:], (h, w))
    for k in got:
        assert torch.equal(got[k], want[k].reshape(got[k].shape)), k


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 256), (37, 53)])
def test_fused_adapter_at_three_gaussians_a_pixel_matches_the_plain_stage(shape):
    """The kernel (one launch) at gpp = 3 against the plain stage: all six
    outputs within _torch_cases.ADAPTER_TOL, the (view, pixel, sample) order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the adapter kernel has no CPU mode")
    from _torch_cases import ADAPTER_TOL, adapter_case, adapter_errors

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg, args = adapter_case(torch.device("cuda"), 1, 2, shape, 4, 3, seed=8, samples=3)
    kernels.reset_launches()
    got = adapt_stage(cfg, *args, with_aux=True)
    assert kernels.launches == {"gaussian_adapter": 1}
    assert got["means"].shape == (1, 2 * shape[0] * shape[1] * 3, 3)
    errs = adapter_errors(got, adapt_stage_plain(cfg, *args, with_aux=True))
    assert max(errs.values()) <= ADAPTER_TOL, errs


@pytest.mark.parametrize("encoder,depth,layers,features", [
    ("vits", 12, (2, 5, 8, 11), 64), ("vitb", 12, (2, 5, 8, 11), 128), ("vitl", 24, (4, 11, 17, 23), 256),
])
def test_dav2_encoders_have_their_depth_and_read_their_layers(encoder, depth, layers, features):
    """Depth-Anything-V2's ViTs on the meta device: vitl has 24 blocks and
    reads blocks 4, 11, 17 and 23; TranSplat's depth predictor takes the
    head's features // 2 channels from each."""
    from transplat_tpu_torch.model.dav2 import DepthAnythingV2
    from transplat_tpu_torch.model.encoder import EncoderCfg, EncoderTranSplat

    with torch.device("meta"):
        dav2 = DepthAnythingV2(encoder)
        enc = EncoderTranSplat(EncoderCfg(dav2_encoder=encoder), device="meta")
    vit = dav2.pretrained
    assert vit.depth == depth and sum(n.startswith("block_") for n, _ in vit.named_children()) == depth
    assert tuple(dav2.take_layers) == layers
    read = []
    for i in range(depth):
        getattr(vit, f"block_{i}").register_forward_hook(lambda m, a, o, i=i: read.append(i))
    tokens = vit(torch.empty(1, 28, 28, 3, device="meta"), take_layers=dav2.take_layers)
    assert len(tokens) == 4 and read == list(range(depth))
    assert enc.depth_predictor.cam_param_encoder.reduce_conv_0.in_channels == features // 2


def _camera(rng) -> tuple[torch.Tensor, torch.Tensor]:
    """A random camera-to-world pose and skewed, off-centre normalized intrinsics (float64)."""
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    e = np.eye(4)
    e[:3, :3], e[:3, 3] = rot, rng.standard_normal(3)
    k = np.array([[rng.uniform(0.7, 1.3), rng.uniform(-0.05, 0.05), rng.uniform(0.3, 0.7)],
                  [0.0, rng.uniform(0.7, 1.3), rng.uniform(0.3, 0.7)], [0.0, 0.0, 1.0]])
    return torch.from_numpy(e), torch.from_numpy(k)


def _image_point(point, extr, intr) -> torch.Tensor:
    p = (torch.linalg.inv(extr) @ torch.cat([point, torch.ones(1, dtype=torch.float64)]))[:3]
    return (intr @ p)[:2] / (intr @ p)[2]


def _march(origins, directions, extr, intr, near, far, steps=20001, eps=1e-6):
    """A dense march of every ray over [near, far]: t (steps,) and, for each
    ray, which points land on the image in front of the camera (R, steps)."""
    t = torch.linspace(near, far, steps, dtype=torch.float64)
    pts = origins[:, None] + t[None, :, None] * directions[:, None]
    w2c = torch.linalg.inv(extr)
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    pix = cam @ intr.T
    xy = pix[..., :2] / pix[..., 2:]
    return t, (pix[..., 2] >= eps) & (xy >= 0).all(-1) & (xy <= 1).all(-1)


def _rays(rng, extr, intr):
    """Rays from random places in random directions; rays from in front of the
    camera aimed at and past the image's corners (just inside: grazing; just
    outside: missing); rays from behind the camera pointing away from it."""
    centre, rot, k_inv = extr[:3, 3], extr[:3, :3], torch.linalg.inv(intr)
    out = [(centre + torch.from_numpy(rng.standard_normal(3) * 3), torch.from_numpy(rng.standard_normal(3)))
           for _ in range(60)]
    forward = rot[:, 2]
    for cx, cy in ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)):
        for nudge in (-1e-3, 1e-3):
            target = centre + 5.0 * rot @ (k_inv @ torch.tensor([cx + nudge * (1 - 2 * cx), cy + nudge * (1 - 2 * cy), 1.0],
                                                               dtype=torch.float64))
            origin = centre + 2.0 * forward + torch.from_numpy(rng.standard_normal(3) * 0.5)
            out.append((origin, target - origin))
    for _ in range(5):
        out.append((centre - 2.0 * forward + torch.from_numpy(rng.standard_normal(3) * 0.1), -forward))
    return [(o, d / torch.linalg.norm(d)) for o, d in out]


def test_project_rays_clips_segments_to_the_image_as_a_dense_march_finds_them():
    """Every clipped segment against a march of 20,001 points over [near,
    far]: where the march lands on the image the segment does too, and its
    ends are the first and last points marched within a march step; where
    the march never lands, the segment is empty or shorter than a step (a
    graze between two points). Each end lies on the image's border or is
    the near or far point's image."""
    from transplat_tpu_torch.geometry.epipolar import project_rays

    rng = np.random.default_rng(0)
    seen = {"hit": 0, "miss": 0}
    for _ in range(4):
        extr, intr = _camera(rng)
        rays = _rays(rng, extr, intr)
        origins = torch.stack([o for o, _ in rays])
        dirs = torch.stack([d for _, d in rays])
        near, far = torch.full((len(rays),), 0.5, dtype=torch.float64), torch.full((len(rays),), 20.0, dtype=torch.float64)
        xy0, xy1, on = project_rays(origins, dirs, extr, intr, near, far)
        t, landed = _march(origins, dirs, extr, intr, 0.5, 20.0)
        step = float(t[1] - t[0])
        for i, (o, d) in enumerate(rays):
            hits = t[landed[i]]
            if len(hits) == 0:
                seen["miss"] += 1
                if bool(on[i]):  # a graze the march stepped over: the segment is shorter than a step
                    fine_t, fine = _march(o[None], d[None], extr, intr, 0.5, 20.0, steps=2_000_001)
                    assert int(fine.sum()) < 200, i
                continue
            seen["hit"] += 1
            assert bool(on[i]), i
            for end, t_in, t_out in ((xy0[i], hits[0], hits[0] - step), (xy1[i], hits[-1], hits[-1] + step)):
                # The end lies between the last point marched off the image and the first on it.
                p_in, p_out = (_image_point(o + tt * d, extr, intr) for tt in (t_in, t_out))
                tol = float(torch.linalg.norm(p_out - p_in)) if 0.5 < t_out < 20.0 else 0.0
                assert float(torch.linalg.norm(end - p_in)) <= tol + 1e-9, (i, end, p_in)
            for end, t_end in ((xy0[i], 0.5), (xy1[i], 20.0)):
                on_border = bool(((end - 0).abs() < 1e-9).any() or ((end - 1).abs() < 1e-9).any())
                at_end = _image_point(o + t_end * d, extr, intr)
                assert on_border or float(torch.linalg.norm(end - at_end)) < 1e-9, (i, end)
    assert seen["hit"] >= 20 and seen["miss"] >= 20, seen


def test_a_profiled_forward_opens_each_stage_span_once():
    """The encoder's five epipolar_* spans and the shared adapter span, each
    once a forward, and the sampler's two counters."""
    torch.manual_seed(0)
    encoder = EncoderEpipolar(EncoderEpipolarCfg(), device="cpu")
    gen = torch.Generator().manual_seed(1)
    images = torch.rand(1, 2, 32, 32, 3, generator=gen)
    intr = torch.tensor([[0.9, 0.0, 0.5], [0.0, 0.9, 0.5], [0.0, 0.0, 1.0]]).expand(1, 2, 3, 3)
    extr = torch.eye(4).repeat(1, 2, 1, 1)
    extr[0, 1, 0, 3] = 0.3
    near, far = torch.ones(1, 2), torch.full((1, 2), 100.0)
    trace.reset_counters()
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        encoder(images, intr, extr, near, far)
    names = [e.name for e in prof.events()]
    assert {s: names.count(s) for s in STAGES} == dict.fromkeys(STAGES, 1)
    c = trace.counters()
    assert c["epipolar.rays"] == 2 * 8 * 8 and 0 < c["epipolar.rays_on_image"] <= 2 * 8 * 8


def test_main_test_evaluates_pixelsplat_stage_by_stage(tmp_path, capsys):
    """`main test --experiment pixelsplat_re10k` on a seeded chunk at 64^2:
    create_train_state builds pixelSplat's encoder (model.build_encoder),
    the evaluator encodes through it stage by stage and scores the render."""
    import json

    from transplat_tpu_torch.dataset import chunks
    from transplat_tpu_torch.main import main

    root = tmp_path / "data"
    chunks.write_chunk(root / "test" / "000000.torch", [chunks.make_scene("te_0", 60, seed=5)])
    index = tmp_path / "index.json"
    assert main(["generate-index", "--dataset-root", str(root), "--output", str(index), "--device", "cpu"]) == 0
    out = tmp_path / "scores"
    assert main(["test", "--experiment", "pixelsplat_re10k", "--dataset-root", str(root), "--evaluation-index",
                 str(index), "--output", str(out), "--device", "cpu", "dataset.image_shape=[64, 64]",
                 "test.stage_timing=true"]) == 0
    scores = json.loads((out / "scores_per_scene.json").read_text())["te_0"]
    assert all(np.isfinite(scores[k]) for k in ("psnr", "ssim", "lpips"))
    summary = json.loads((out / "benchmark.json").read_text())["summary"]
    assert all(stage in summary for stage in STAGES)
