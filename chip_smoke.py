#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py

1. Builds the CUDA kernels from transplat_tpu_torch/csrc (nvcc, sm_90a).
2. The slice: the full-width re10k encoder with random weights from a seeded
   generator (cross-attention offsets perturbed, so samples fall between
   pixels and outside the map) serves one warm-up and five requests of
   2 context views at 256x256 -> 131,072 Gaussians -> 4 target views at
   256x256. Launch counts are reset just before the five requests and read
   just after; every kernel of the path must have launched.
3. Each kernel is held against its plain PyTorch version on the card at the
   shapes of the path (K1 and K3 on the Gaussians a request produced, and
   on a synthetic scene of elongated splats), and timed with CUDA events.
4. The tiled renderer is held against the naive oracle, and the whole slice
   at a tiny width against the plain versions on the CPU.

Prints JSON records, then the card's name and power limit as nvidia-smi
gives them, a `kernels` record, and as the last line
{"ok": true, "device": {...}}. Exits non-zero if there is no CUDA card or
any check fails. Float32 throughout, TF32 off.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM float32, CUDA cores
SEED = 0
IMAGE = (256, 256)
NUM_TARGET = 4
REQUESTS = 5


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median ms of fn() between CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def synthetic_scene(g: int, views: int, dev, seed: int):
    """g Gaussians in front of `views` cameras, a third of them needle-like."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-3, 3, g), rng.uniform(-3, 3, g), rng.uniform(2.0, 10.0, g)], 1)
    s = rng.uniform(0.003, 0.02, (g, 3))
    s[: g // 3, 0] *= 20.0
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    rot = np.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
         2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
         2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], 1,
    ).reshape(g, 3, 3)
    cov = rot @ (s[:, :, None] ** 2 * rot.transpose(0, 2, 1))
    t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    rep = lambda a: t(np.broadcast_to(a, (views,) + a.shape))  # noqa: E731
    extr = np.tile(np.eye(4), (views, 1, 1))
    extr[:, 0, 3] = np.linspace(-0.3, 0.3, views)
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]), (views, 1, 1))
    cams = (t(extr), t(intr), torch.ones(views, device=dev), torch.full((views,), 100.0, device=dev))
    gs = (rep(means), rep(cov), rep(rng.standard_normal((g, 3, 4)) * 0.4), rep(rng.uniform(0.5 / 255, 0.9, g)))
    return cams, gs


def touched_sectors(loc: torch.Tensor, h: int, w: int) -> int:
    """32-byte sectors of the score rows that the in-range bilinear corners of
    `loc` (..., Q, D, P, 2) hit, counted per query row (rows are 32-byte
    aligned): the score bytes that K5 must read on these inputs."""
    px = torch.floor(loc[..., 0] * w - 0.5).clamp(-2.0, w + 1.0).long()
    py = torch.floor(loc[..., 1] * h - 0.5).clamp(-2.0, h + 1.0).long()
    rows = px.numel() // (px.shape[-1] * px.shape[-2])
    sectors = []
    for dy in (0, 1):
        for dx in (0, 1):
            ix, iy = px + dx, py + dy
            inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            sectors.append(torch.where(inside, (iy * w + ix) // 8, -1).reshape(rows, -1))
    sec, _ = torch.sort(torch.cat(sectors, dim=1), dim=1)
    first = torch.ones_like(sec[:, :1], dtype=torch.bool)
    new = torch.cat([first, sec[:, 1:] != sec[:, :-1]], dim=1) & (sec >= 0)
    return int(new.sum())


def check_deform(dev, p: int, launches: dict) -> dict:
    """K5 at the path's shapes: 2 directed pairs x 4096 queries, 64x64 maps, D = 128."""
    from torch.nn import functional as F

    from transplat_tpu_torch.ops import deform

    n, q, d, h, w = 2, 4096, 128, 64, 64
    gen = torch.Generator(device=dev).manual_seed(SEED + p)
    scores = torch.randn((n, q, h * w), device=dev, generator=gen)
    loc = torch.rand((n, q, d, p, 2), device=dev, generator=gen) * 1.2 - 0.1
    loc[:, :, : d // 4] = torch.round(loc[:, :, : d // 4] * w) / w  # exact corner boundaries
    aw = torch.ones((n, q, d, p), device=dev) if p == 1 else torch.softmax(
        torch.randn((n, q, d, p), device=dev, generator=gen), dim=-1
    )
    out = deform.deform_sample_scores(scores, (h, w), loc, aw)
    ref = deform.deform_sample_scores_plain(scores, (h, w), loc, aw)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    tol = 1e-5
    require(err <= tol, f"deform_scores P={p}: max abs err {err} > {tol}")
    ms = time_ms(lambda: deform.deform_sample_scores(scores, (h, w), loc, aw))
    plain_ms = time_ms(lambda: deform.deform_sample_scores_plain(scores, (h, w), loc, aw), iters=5, warmup=1)
    library_ms = None
    if p == 1:  # grid_sample computes the same function when P = 1 and the weights are 1
        grid = (loc * 2.0 - 1.0).reshape(n * q, d, 1, 2)
        img = scores.reshape(n * q, 1, h, w)
        lib = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
        require(max_err(lib.reshape(n, q, d), ref) <= tol, "grid_sample disagrees with the plain version")
        library_ms = time_ms(lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False))
    samples = n * q * d * p
    sectors = touched_sectors(loc, h, w)
    nbytes = 32 * sectors + 4 * (loc.numel() + aw.numel() + out.numel())
    b_ms, b_by = bound(nbytes, samples * 30.0)
    name = f"deform_scores_p{p}"
    rec = dict(
        name=name, route="cuda", source="transplat_tpu_torch/csrc/deform_scores.cu",
        replaces="transplat_tpu/ops/deform_pallas.py:84", launches=launches.get(name, 0),
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
    )
    emit({"phase": "kernel", "tolerance": tol, "shape": dict(pairs=n, q=q, d=d, p=p, h=h, w=w),
          "score_sectors_touched": sectors, "score_sectors_total": n * q * h * w // 8, **rec})
    return rec


def check_raster(proj, image_shape, launches: dict, label: str, timed: bool) -> list[dict]:
    """K1 (bin_rects, bin_emit, bin_ranges) and K3 (composite) against their
    plain versions on one set of projected Gaussians."""
    from transplat_tpu_torch.ops.rasterizer import binning, composite

    tol = 1e-5
    gfeat, colors = binning.sort_by_depth(proj)
    b, g, _ = gfeat.shape
    ntx, nty = binning.grid_size(image_shape, 16)
    t_count = ntx * nty
    rects, counts = binning.bin_rects(gfeat, ntx, nty, 16)
    rects_p, counts_p = binning.bin_rects_plain(gfeat, ntx, nty, 16)
    require(torch.equal(rects, rects_p) and torch.equal(counts, counts_p), f"{label}: bin_rects != plain")
    incl = torch.cumsum(counts.reshape(-1), 0, dtype=torch.int64)
    total = int(incl[-1])
    keys, vals = binning.bin_emit(rects, counts, incl, total, t_count, ntx)
    keys_p, vals_p = binning.bin_emit_plain(rects, counts, incl, total, t_count, ntx)
    require(torch.equal(keys, keys_p) and torch.equal(vals, vals_p), f"{label}: bin_emit != plain")
    keys_sorted, perm = torch.sort(keys, stable=True)
    cells = b * t_count
    ranges = binning.bin_ranges(keys_sorted, cells)
    require(torch.equal(ranges, binning.bin_ranges_plain(keys_sorted, cells)), f"{label}: bin_ranges != plain")
    lists = binning.TileLists(vals[perm].contiguous(), ranges, ntx, nty)
    bg = torch.zeros((b, colors.shape[-1]), device=gfeat.device)
    img = composite.composite_tiles(gfeat, colors, lists, bg, image_shape)
    img_p, evaluations = composite.composite_tiles_plain(gfeat, colors, lists, bg, image_shape)
    torch.cuda.synchronize()
    err = max_err(img, img_p)
    require(err <= tol, f"{label}: composite max abs err {err} > {tol}")
    sizes = dict(views=b, gaussians=g, pairs=total, h=image_shape[0], w=image_shape[1])
    emit({"phase": "raster_check", "scene": label, "tolerance": tol, "composite_max_abs_err": err,
          "binning_exact": True, "evaluations": evaluations, **sizes})
    if not timed:
        return []
    srcs = dict(bin="transplat_tpu_torch/csrc/binning.cu", comp="transplat_tpu_torch/csrc/composite.cu")
    k1 = "transplat_tpu/ops/rasterizer/pallas_binning.py:276"
    k3 = "transplat_tpu/ops/rasterizer/pallas_composite.py:160"
    boundaries = torch.arange(cells + 1, dtype=keys_sorted.dtype, device=keys_sorted.device)
    recs = []
    specs = [
        ("bin_rects", srcs["bin"], k1, 0.0,
         lambda: binning.bin_rects(gfeat, ntx, nty, 16), lambda: binning.bin_rects_plain(gfeat, ntx, nty, 16), None,
         4 * b * g * (8 + 4 + 1), b * g * 40.0),
        ("bin_emit", srcs["bin"], k1, 0.0,
         lambda: binning.bin_emit(rects, counts, incl, total, t_count, ntx),
         lambda: binning.bin_emit_plain(rects, counts, incl, total, t_count, ntx), None,
         b * g * (16 + 4 + 8) + 8 * total, 4.0 * total),
        ("bin_ranges", srcs["bin"], k1, 0.0,
         lambda: binning.bin_ranges(keys_sorted, cells), lambda: binning.bin_ranges_plain(keys_sorted, cells),
         lambda: torch.searchsorted(keys_sorted, boundaries),
         4 * total + 8 * cells, 3.0 * total),
        ("composite", srcs["comp"], k3, err,
         lambda: composite.composite_tiles(gfeat, colors, lists, bg, image_shape),
         lambda: composite.composite_tiles_plain(gfeat, colors, lists, bg, image_shape), None,
         4 * (gfeat.numel() + colors.numel() + total + 2 * cells + bg.numel() + img.numel()),
         evaluations * (20.0 + 2 * colors.shape[-1])),
    ]
    for name, src, replaces, e, fn, plain_fn, lib_fn, nbytes, flops in specs:
        b_ms, b_by = bound(nbytes, flops)
        rec = dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=launches.get(name, 0),
            max_abs_err=e, ms=time_ms(fn), plain_ms=time_ms(plain_fn, iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None if lib_fn is None else time_ms(lib_fn),
        )
        emit({"phase": "kernel", "scene": label, **sizes, **rec})
        recs.append(rec)
    return recs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on an NVIDIA card", file=sys.stderr)
        return 2
    from transplat_tpu_torch import kernels
    from transplat_tpu_torch.dataset import synthetic_batch
    from transplat_tpu_torch.inference import init_random, re10k_encoder_cfg, render_novel_views
    from transplat_tpu_torch.model.encoder import EncoderTranSplat
    from transplat_tpu_torch.ops.rasterizer import api

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    kernels.load()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi, "build_s": build_s,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- the slice: five full-width requests ------------------------------
    cfg = re10k_encoder_cfg()
    encoder = EncoderTranSplat(cfg, device="cuda")
    init_random(encoder, SEED)
    batch = synthetic_batch(SEED, batch_size=1, num_context=2, num_target=NUM_TARGET, image_shape=IMAGE)
    ctx, tgt = batch["context"], batch["target"]
    render_novel_views(encoder, ctx, tgt, IMAGE)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        out = render_novel_views(encoder, ctx, tgt, IMAGE)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    path_kernels = ("deform_scores_p1", "deform_scores_p4", "bin_rects", "bin_emit", "bin_ranges", "composite")
    require(tuple(out.shape) == (1, NUM_TARGET, *IMAGE, 3), f"output shape {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), "non-finite output")
    for name in path_kernels:
        require(launches.get(name, 0) > 0, f"kernel {name} was not launched on the main path")
    with torch.no_grad():
        gaussians = encoder(*(torch.as_tensor(ctx[k], device=dev) for k in ("image", "intrinsics", "extrinsics", "near", "far")))
    g = gaussians.means.shape[1]
    require(g == 2 * IMAGE[0] * IMAGE[1], f"{g} Gaussians")
    emit({"phase": "slice", "requests": REQUESTS, "ms_per_request": float(np.median(times)), "ms_all": times,
          "peak_mem_bytes": peak, "gaussians": g, "output_shape": list(out.shape), "finite": True,
          "launches": launches})

    # ---- every kernel against its plain version ---------------------------
    records = [check_deform(dev, 1, launches), check_deform(dev, 4, launches)]
    tv = NUM_TARGET
    rep = lambda x: x.expand(tv, *x.shape[1:]).contiguous()  # noqa: E731
    cams = [torch.as_tensor(tgt[k][0], device=dev) for k in ("extrinsics", "intrinsics", "near")]
    with torch.no_grad():
        proj = api.project_views(*cams, *(rep(x) for x in gaussians), IMAGE)
        records += check_raster(proj, IMAGE, launches, "encoder_request", timed=True)
        scams, sgs = synthetic_scene(g, tv, dev, SEED + 1)
        check_raster(api.project_views(*scams[:2], scams[2], *sgs, IMAGE), IMAGE, launches, "elongated_synthetic", timed=False)

        # The tiled renderer (kernels) against the naive oracle, small scene.
        scams, sgs = synthetic_scene(2048, 2, dev, SEED + 2)
        bg = torch.tensor([[0.2, 0.5, 0.9], [0.0, 0.0, 0.0]], device=dev)
        fast = api.render(*scams, (64, 64), bg, *sgs).color
        oracle = api.render(*scams, (64, 64), bg, *sgs, cfg=api.RasterizeConfig(mode="reference")).color
        err = max_err(fast, oracle)
        require(err <= 1e-5, f"renderer vs oracle: {err}")
        emit({"phase": "oracle_check", "gaussians": 2048, "views": 2, "h": 64, "w": 64, "max_abs_err": err, "tolerance": 1e-5})

    # ---- the slice at a tiny width: card kernels vs CPU plain versions -----
    from transplat_tpu_torch.model.adapter import GaussianAdapterCfg
    from transplat_tpu_torch.model.decoder import decode_splatting
    from transplat_tpu_torch.model.encoder import EncoderCfg

    tiny = EncoderCfg(
        d_feature=16, num_depth_candidates=16, costvolume_unet_feat_dim=16, costvolume_unet_channel_mult=(1, 1),
        costvolume_unet_attn_res=(2,), depth_unet_feat_dim=8, depth_unet_attn_res=(4,),
        depth_unet_channel_mult=(1, 1, 1), dav2_encoder="vits", dav2_input_size=28,
        gaussian_adapter=GaussianAdapterCfg(sh_degree=1),
    )
    enc_gpu = EncoderTranSplat(tiny, device="cuda")
    init_random(enc_gpu, SEED + 3)
    with torch.no_grad():  # keep depths off the 1/far clip, where 1/disparity amplifies rounding
        enc_gpu.depth_predictor.to_disparity_2.weight[0] *= 0.01
    enc_cpu = EncoderTranSplat(tiny, device="cpu")
    enc_cpu.load_state_dict(enc_gpu.state_dict())
    small = synthetic_batch(SEED + 3, image_shape=(64, 64), num_target=2)
    ctx_keys = ("image", "intrinsics", "extrinsics", "near", "far")
    with torch.no_grad():
        g_gpu = enc_gpu(*(torch.as_tensor(small["context"][k], device=dev) for k in ctx_keys))
        g_cpu = enc_cpu(*(torch.as_tensor(small["context"][k]) for k in ctx_keys))
    for a, b_ in zip(g_gpu, g_cpu):
        err = (a.cpu() - b_).abs() - 1e-3 * b_.abs()
        require(bool(torch.isfinite(a).all()) and float(err.max()) <= 1e-3, f"tiny Gaussians card vs CPU: {float(err.max())}")
    cams = [torch.as_tensor(small["target"][k]) for k in ("extrinsics", "intrinsics", "near", "far")]
    same_gpu = decode_splatting(type(g_cpu)(*(x.to(dev) for x in g_cpu)), *(c.to(dev) for c in cams), (64, 64)).color
    same_cpu = decode_splatting(g_cpu, *cams, (64, 64)).color
    on_gpu = render_novel_views(enc_gpu, small["context"], small["target"], (64, 64), device="cuda")
    on_cpu = render_novel_views(enc_cpu, small["context"], small["target"], (64, 64), device="cpu")
    same_err = (same_gpu.cpu() - same_cpu).abs()
    e2e_err = (on_gpu.cpu() - on_cpu).abs()
    # The integer cutoff radius and the 1/255 alpha floor make the image a
    # step function of the Gaussians; see tests/test_torch_encoder.py.
    for name, e in (("same Gaussians", same_err), ("end to end", e2e_err)):
        require(float((e > 1e-4).float().mean()) < 0.02 and float(e.max()) < 0.05, f"tiny slice {name}: {float(e.max())}")
    emit({"phase": "tiny_slice_vs_cpu", "same_gaussians_max_abs_err": float(same_err.max()),
          "end_to_end_max_abs_err": float(e2e_err.max()),
          "end_to_end_share_beyond_1e-4": float((e2e_err > 1e-4).float().mean()),
          "tolerance": "98% within 1e-4, all within 0.05"})

    print(smi, flush=True)
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
