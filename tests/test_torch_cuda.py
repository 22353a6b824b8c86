"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one:
a CUDA kernel has no CPU mode. The file imports nothing of JAX, so it runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import synthetic_scene as scene
from transplat_tpu_torch import kernels
from transplat_tpu_torch.ops import deform
from transplat_tpu_torch.ops.rasterizer import api, binning, composite
from transplat_tpu_torch.ops.rasterizer.api import RasterizeConfig

pytestmark = pytest.mark.cuda

# Kernel and plain version do the same float32 arithmetic, the plain version
# in another summation order (cumprod per chunk, sums over corners): 1e-5.
ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _deform_case(q, d, p, h, w, seed, dev):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((q, h * w)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (q, d, p, 2)).astype(np.float32)
    loc[:, : d // 4] = np.round(loc[:, : d // 4] * w) / w  # exact corner boundaries
    aw = rng.random((q, d, p)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (scores, loc, aw)]


@pytest.mark.parametrize(
    "q,d,p,h,w", [(4096, 128, 4, 64, 64), (4096, 128, 1, 64, 64), (37, 5, 3, 7, 11), (8, 4, 2, 160, 160)]
)
def test_deform_scores(dev, q, d, p, h, w):
    scores, loc, aw = _deform_case(q, d, p, h, w, q + d, dev)
    out = deform.deform_sample_scores(scores, (h, w), loc, aw)
    ref = deform.deform_sample_scores_plain(scores, (h, w), loc, aw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL)


@pytest.mark.parametrize("image_shape", [(64, 80), (100, 76)])
def test_binning_kernels_equal_plain(dev, image_shape):
    cams, gs = scene(3000, 3, dev, 1)
    proj = api.project_views(*cams[:2], cams[2], *gs, image_shape)
    gfeat, _ = binning.sort_by_depth(proj)
    ntx, nty = binning.grid_size(image_shape, 16)
    rects, counts = binning.bin_rects(gfeat, ntx, nty, 16)
    rects_p, counts_p = binning.bin_rects_plain(gfeat, ntx, nty, 16)
    assert torch.equal(counts, counts_p) and torch.equal(rects, rects_p)
    incl = torch.cumsum(counts.reshape(-1), 0, dtype=torch.int64)
    total = int(incl[-1])
    keys, vals = binning.bin_emit(rects, counts, incl, total, ntx * nty, ntx)
    keys_p, vals_p = binning.bin_emit_plain(rects, counts, incl, total, ntx * nty, ntx)
    assert torch.equal(keys, keys_p) and torch.equal(vals, vals_p)
    keys_sorted, _ = torch.sort(keys, stable=True)
    cells = gfeat.shape[0] * ntx * nty
    assert torch.equal(binning.bin_ranges(keys_sorted, cells), binning.bin_ranges_plain(keys_sorted, cells))


@pytest.mark.parametrize("image_shape", [(64, 80), (100, 76)])
def test_render_kernels_match_plain(dev, image_shape):
    cams, gs = scene(3000, 3, dev, 2)
    bg = torch.tensor([[0.2, 0.5, 0.9], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], device=dev)
    kernels.reset_launches()
    out = api.render(*cams, image_shape, bg, *gs)
    assert {"bin_rects", "bin_emit", "bin_ranges", "composite"} <= set(kernels.launches)
    # The plain compositor on the same lists (the binning kernels equal their
    # plain versions exactly, test above), and the naive oracle.
    gfeat, colors = binning.sort_by_depth(api.project_views(*cams[:2], cams[2], *gs, image_shape))
    lists = binning.bin_gaussians(gfeat, image_shape)
    plain, _ = composite.composite_tiles_plain(gfeat, colors, lists, bg, image_shape)
    ref = api.render(*cams, image_shape, bg, *gs, cfg=RasterizeConfig(mode="reference"))
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.color.cpu().numpy(), plain.cpu().numpy(), atol=ATOL)
    np.testing.assert_allclose(out.color.cpu().numpy(), ref.color.cpu().numpy(), atol=ATOL)
    depth = api.render_depth(*cams, image_shape, gs[0], gs[1], gs[3])
    depth_ref = api.render_depth(*cams, image_shape, gs[0], gs[1], gs[3], cfg=RasterizeConfig(mode="reference"))
    # Depth features reach ~8: relative 2e-6 on top of the absolute bound.
    np.testing.assert_allclose(depth.cpu().numpy(), depth_ref.cpu().numpy(), atol=ATOL, rtol=2e-6)


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(ValueError):
        deform.deform_sample_scores(
            torch.zeros(4, 16, device=dev, dtype=torch.float64), (4, 4),
            torch.zeros(4, 2, 1, 2, device=dev), torch.zeros(4, 2, 1, device=dev),
        )
    with pytest.raises(ValueError):
        binning.bin_rects(torch.zeros(1, 4, 7, device=dev), 2, 2, 16)
    with pytest.raises(ValueError):
        composite.composite_tiles(
            torch.zeros(1, 4, 8, device=dev), torch.zeros(1, 4, 3, device=dev),
            binning.TileLists(torch.zeros(0, dtype=torch.int32, device=dev), torch.zeros(4, 2, dtype=torch.int32, device=dev), 2, 2),
            torch.zeros(1, 3, device=dev), (32, 32), tile=8,
        )


def test_tiny_encoder_card_matches_cpu(dev):
    """The whole slice at a tiny width: kernels on the card vs plain versions
    on the CPU, same random weights."""
    from transplat_tpu_torch.dataset import synthetic_batch
    from transplat_tpu_torch.inference import render_novel_views
    from transplat_tpu_torch.model.adapter import GaussianAdapterCfg
    from transplat_tpu_torch.model.encoder import EncoderCfg, EncoderTranSplat

    cfg = EncoderCfg(
        d_feature=16, num_depth_candidates=16, costvolume_unet_feat_dim=16, costvolume_unet_channel_mult=(1, 1),
        costvolume_unet_attn_res=(2,), depth_unet_feat_dim=8, depth_unet_attn_res=(4,),
        depth_unet_channel_mult=(1, 1, 1), dav2_encoder="vits", dav2_input_size=28,
        gaussian_adapter=GaussianAdapterCfg(sh_degree=1),
    )
    torch.manual_seed(0)
    enc_cpu = EncoderTranSplat(cfg, device="cpu")
    with torch.no_grad():  # keep depths off the 1/far clip (see test_torch_encoder.py)
        enc_cpu.depth_predictor.to_disparity_2.weight[0] *= 0.01
    enc_gpu = EncoderTranSplat(cfg, device="cuda")
    enc_gpu.load_state_dict(enc_cpu.state_dict())
    batch = synthetic_batch(0, image_shape=(64, 64), num_target=2)
    ctx = [batch["context"][k] for k in ("image", "intrinsics", "extrinsics", "near", "far")]
    with torch.no_grad():
        g_gpu = enc_gpu(*(torch.as_tensor(a, device=dev) for a in ctx))
        g_cpu = enc_cpu(*(torch.as_tensor(a) for a in ctx))
    # Two devices run convolutions and matmuls in other orders: 1e-3.
    for a, b in zip(g_gpu, g_cpu):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-3, rtol=1e-3)
    kernels.reset_launches()
    out_gpu = render_novel_views(enc_gpu, batch["context"], batch["target"], (64, 64), device="cuda")
    out_cpu = render_novel_views(enc_cpu, batch["context"], batch["target"], (64, 64), device="cpu")
    assert all(kernels.launches.get(k, 0) > 0 for k in ("deform_scores_p1", "deform_scores_p4", "composite"))
    # The image is a step function of the Gaussians (integer cutoff radius,
    # 1/255 alpha floor; see test_torch_encoder.py): 98% within 1e-4.
    diff = np.abs(out_gpu.cpu().numpy() - out_cpu.numpy())
    assert np.mean(diff > 1e-4) < 0.02 and diff.max() < 0.05, (np.mean(diff > 1e-4), diff.max())
