#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and fit -> checkpoint ->
evaluate paths (validation media included), its stage tools, data path,
command line, checkpoint converter and multi-rank training, on one NVIDIA
card and check them.

    python3 chip_smoke.py

1. Builds the CUDA kernels from transplat_tpu_torch/csrc (nvcc, sm_90a).
2. Serving: the full-width re10k encoder with random weights from a seeded
   generator (cross-attention offsets perturbed, so samples fall between
   pixels and outside the map) serves one warm-up and five requests of
   2 context views at 256x256 -> 131,072 Gaussians -> 4 target views at
   256x256. Launch counts are reset just before the five requests and read
   just after; every forward kernel must have launched.
3. Each kernel is held against its plain PyTorch version on the card at the
   shapes of the paths (K1, K3, K4 and K2 on the Gaussians a request
   produced and on a synthetic scene of elongated splats; K1's three kernels
   and their lists, equal bit for bit to the classic route's (a key per
   pair, torch.sort), also on synthetic scenes with a dead-heavy and an
   all-dead view, a grid wider than one shared-memory histogram, Gaussians
   that cover every tile and no pairs at all; K3, K4 and K2's sorted mode
   give the same bits on both routes' lists; K5 and K6 at 2 x
   4096 queries of 64x64 maps; K7 and K8, both modes, at 2 x 4096 queries
   of a 64x64x128 value map with self-attention-like locations; K5 at P = 1
   also on the encoder's own epipolar locations, K6 at P = 4 on the
   encoder's own cross-attention locations, K6 at a shape that takes its
   general path), and timed beside its bound, its plain version and, where
   there is one, a library call (grid_sample, index_add_, searchsorted):
   device time by torch.profiler (median of 20 calls; `device_ms` with the
   wrapper's fills, `kernel_ms` the kernel alone, see
   transplat_tpu_torch/utils/device_time.py; `kernel_cold_ms` /
   `device_cold_ms` the same with the L2 flushed before each call) and
   `wrapper_ms`, one wrapper call between CUDA events. K3 and K4 also record
   registers, shared memory, resident blocks per SM, waves and their blocks'
   time spread (transplat_tpu_torch/raster_report.py); two runs of K4, K6
   and of the sorted modes of K2 and K8 must give the same bits. The sorted
   modes order their entries with hand-written kernels and no library sort
   (`bin_bwd_order`, `deform_vectors_bwd_order`, each its own record): their
   permutation and segments must equal torch.sort's (on every K1 scene, and
   for K8 also on maps of 5x7, 128x160 in four histogram slices and 1x1),
   their outputs the route that took torch.sort's order bit for bit, and no
   cub / radix / sort kernel of a library may run inside either wrapper
   (torch.sort's own route must show one: the check sees them). Their
   records' library call is index_add_ under
   torch.use_deterministic_algorithms (the orders': torch.sort).
4. The tiled renderer is held against the naive oracle, and the serving
   slice at a tiny width against the plain versions on the CPU.
5. Training (`train_slice`): the same full-width configuration takes one
   warm-up and three timed steps through make_train_step (MSE + random-init
   LPIPS, backward, clip 0.5 + Adam, dropout on). Launch counts are reset
   just before the timed steps; every forward and backward kernel must have
   launched, every trainable parameter must have moved, DAv2 must not, and
   the loss on the fixed batch (dropout off) must be lower afterwards. K2
   and K8 must have launched their atomic modes, not their sorted ones.
   `train_deterministic`: with trainer.deterministic_kernels on, two steps
   from one state must give the same loss, gradients and parameters bit for
   bit, through the sorted modes of K2 and K8 (their orders' kernels
   launched) and no atomic mode; the
   warnings of torch.use_deterministic_algorithms during such a step are
   recorded. `precision_remat`: the same step with s2d_unet off in four
   settings (float32; compute_dtype bfloat16; remat_unet + remat_matching;
   both), each from one state with a warm-up and three timed steps: ms per
   step, peak bytes, launches per step (K5 at P = 4 and K7 exactly 2, and 4
   under remat_matching), no bfloat16 tensor at any kernel wrapper; the bf16
   step's loss and update against the float32 step's; the checkpointed
   forward and backward bit for bit the plain one under
   trainer.deterministic_kernels, in float32 and bf16; a bf16 request
   against the float32 one (ms, the Gaussians' gap).
6. `tiny_train_vs_cpu`: one training step's loss and gradients at a tiny
   width, kernels on the card against plain versions on the CPU.
7. Stage attribution (`stage_attribution`): the stage tools in process at
   full width, STAGE_ITERS timed calls a row (host ms, device ms between
   CUDA events, the card's busy ms under torch.profiler, launches, the
   allocator's peak): profile_stages (per-stage device ms, FLOPs, bytes;
   its staged Gaussians equal to the fused encoder's bit for bit, its
   peak_memory.json's lifetime peak at least every stage's peak),
   bench_encoder_stages, bench_dp_stages in float32 and bfloat16,
   bench_train_stages (its largest sub-graph peak at most the train_slice
   step's) and bench_dataloader against the train_slice step's median.
   Every row launches exactly the kernels STAGE_KERNELS names (the
   matching rows K5 at P = 1 and 4 and K7, with the backward K6 and K8, K6
   at P = 1 only where the backbone's parameters are in the sub-graph; the
   render rows K1 and K3, with the backward K4 and K2; other rows none).
   One record per tool.
8. Fit (`fit_slice`): the same configuration on the 256x256 golden scene.
   Evaluator.evaluate_batch; Trainer.fit for FIT_STEPS steps from an
   in-memory iterator (lr 4e-4 cosine, MSE + random-init LPIPS, one sanity
   validation, a validation and a checkpoint in the middle and at the end,
   into a temporary directory); a fresh Trainer resumed from the middle
   checkpoint, whose first step must log the first run's loss; evaluate_batch
   again. Launch counts are reset just before fit() and read just after: all
   twelve kernels must have launched, and the PSNR must have risen by
   FIT_MIN_PSNR_GAIN_DB. `fit_resume_deterministic`: the same with
   trainer.deterministic_kernels on for FIT_DET_STEPS steps; the resumed
   run's losses and final parameters must equal the first run's exactly.

9. The data path and the command line (`data_cli_phase`, in a temporary
   directory, each part under a time budget): the native library and the
   JPEG route (nvJPEG on a host without libjpeg), a 360x640 batch decoded
   against its source and LANCZOS-rescaled; RE10K-format chunks from a seed
   (train: 2 scenes x 30 frames, test: 2 x 60 on camera paths the index
   generator accepts); `transplat_tpu_torch.main` generate-index, train
   (CLI_TRAIN_STEPS steps at full width with the default 4 forked loader
   workers; validations read the test split; launch counts reset just
   before and read just after: all twelve kernels), test on its checkpoint
   (PSNR, SSIM, LPIPS for both scenes), bench (its JSON line printed as it
   is; its peak memory and tile pairs on an earlier line), and the
   loader's examples per second with 0 and 4 workers.
10. Evaluation from weight files (`eval_artifacts`, inside the data phase's
   directory, on its test chunks and index, under its own budget): a seeded
   encoder tree in the JAX layout and a seeded LPIPS state dict;
   `transplat_tpu_torch.main test` with both, --save-image, stage timing,
   the analysis, videos and PLY (launch counts reset just before and read
   just after: K1, K3, K5 at P = 1 and 4, K7); the loaded encoder equal to
   the tree bit for bit, the staged encoder to the fused one, each PLY to
   the encoder's Gaussians, each video 30 frames at 256x256; a video's
   30-view decode held against the plain versions; a second `main test`
   from seed-init weights and `main compute-metrics` over both runs'
   renders (the run against itself at PSNR_SATURATION_DB). Before the data
   phase, `decode_30_views` times K1 and K3 at the shape of a video's
   decode (30 views x 131,072 Gaussians) on the serving request's Gaussians.
11. Validation media (`validation_media`, inside `fit_slice`): every
   validation of the fit writes its grid, orthographic projections and
   14-frame wobble video; on the fitted state, a validation with and one
   without media are timed; launch counts reset just before a validation
   with media and read just after (K1 and K3 three times each, K5 at P = 1
   and 4, K7); its files and the video read back; the orthographic
   render's K1 lists against the plain versions, its K3 image against
   composite_tiles_plain, and the render on the card against the CPU on a
   seeded subset of the Gaussians; K1 / K3 pairs for the orthographic
   render (3 x 128^2) and the wobble's decode (14 x 256^2), their device
   times taken early, beside decode_30_views (`validation_media_kernels`,
   on the serving encoder's Gaussians of the golden scene).
12. The checkpoint converter (`convert_weights_phase`): `python -m
   transplat_tpu_torch.convert_weights --kind lpips` and its --dry-run on a
   seeded LPIPS state dict; the .npy must load into LPIPS with the bits of
   the state dict loaded directly.
13. DTU's PNG chunks (`dtu_phase`): a chunk packed as scripts/convert_dtu.py
   packs it and `transplat_tpu_torch.main test --experiment dtu` at 3
   context views (launch counts read around it; `launches_dtu`).
14. Data parallelism and the view-sharded decode (`parallel_phase`, last):
   `transplat_tpu_torch.main train --dp 1 --sp 1` on one rank spawned by
   the port's launch (torchrun's environment), NCCL at world size 1,
   PARALLEL_STEPS_NCCL full-width steps over seeded chunks (launch counts
   read in that rank: all twelve kernels); dp = 2 x sp = 1 and dp = 1 x
   sp = 2, one full-width step each on two processes sharing the card over
   gloo (b = 1 a rank), against the one-process step on the joined batch
   within PARALLEL_TOL, a record per run with each rank's tile pairs, K1-K4
   launches, ms per step, peak bytes and the gradient all-reduce's bytes
   and ms (the sp run's launches per rank join the kernels line as
   `launches_sp`); `dryrun_multichip(2)` on the card.

Prints JSON records, then the card's name and power limit as nvidia-smi
gives them, a `kernels` record, and as the last line
{"ok": true, "device": {...}}. Exits non-zero if there is no CUDA card or
any check fails. Float32 throughout (but the bf16 settings of
precision_remat), TF32 off.
"""

from __future__ import annotations

import gc
import json
import re
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
TRAIN_STEPS = 3
FIT_STEPS = 50
FIT_DET_STEPS = 4
# PSNR of evaluate_batch on the golden scene must rise by this much over
# FIT_STEPS steps. Measured on an H100 80GB HBM3: 11.0 -> 26.1 dB, a gain of
# 15 dB (runs differ by a few tenths: the backward's atomics); an optimizer
# or gradient fault that halves the progress fails.
FIT_MIN_PSNR_GAIN_DB = 8.0
FORWARD_KERNELS = (
    "deform_scores_p1", "deform_scores_p4", "deform_vectors", "bin_count", "bin_scan", "bin_place", "composite",
)
BACKWARD_KERNELS = ("deform_scores_bwd_p1", "deform_scores_bwd_p4", "deform_vectors_bwd", "composite_bwd", "bin_bwd")
# What trainer.deterministic_kernels puts in place of K8's and K2's atomic modes.
SORTED_MODES = {"deform_vectors_bwd": "deform_vectors_bwd_sorted", "bin_bwd": "bin_bwd_sorted"}
# The hand-written order of each sorted mode (its stable counting sort; no library sort).
SORTED_ORDERS = {"deform_vectors_bwd_sorted": "deform_vectors_bwd_order", "bin_bwd_sorted": "bin_bwd_order"}
# Device kernels of a library sort (cub's radix sort and scans, PyTorch's
# sorts): none may run inside a sorted mode's wrapper. The port's own
# kernels are named bin_bwd_* and deform_vectors_bwd_*.
LIBRARY_SORT = re.compile(r"cub::|radix|sort", re.IGNORECASE)
OWN_KERNELS = re.compile(r"bin_bwd_|deform_vectors_bwd")
L2_BYTES = 50e6  # H100 L2: a function whose bytes fit reads them from there when called back to back
# Gradients are compared on values scaled to the gradient's largest entry.
# K6 (fixed-point sums), K8 and K2 repeat their plain versions' float32 sums
# in another order: 1e-5. K4 sums an entry's 256 pixels in another order than the
# plain version's chunked cumsum, 1 / (1 - alpha) reaches 100, and where T
# crosses 1e-4 the two forwards (sequential product vs cumprod) can gate an
# entry differently: 1e-4.
GRAD_TOL = {"deform": 1e-5, "bin": 1e-5, "composite": 1e-4}


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


def timings(fn, kernel: str, lib_fn=None) -> dict:
    """A kernel's times: device_ms (every device event of one wrapper call,
    its fill kernels included) and kernel_ms (the hand-written kernel alone,
    by name) from torch.profiler, with the inputs warm as on the path and,
    as `device_cold_ms` / `kernel_cold_ms`, with the L2 flushed before each
    call (what a bound from the device-memory rate holds); wrapper_ms (one
    wrapper call between CUDA events: host time included, what a host-bound
    path pays); the device and wrapper times of the library call where there
    is one. `ms` and `library_ms` are the device times the kernels line
    compares."""
    from transplat_tpu_torch.utils.device_time import device_time

    wrapper_ms = time_ms(fn)  # before the profiler window: it costs the host time while on
    t = device_time(fn, kernel)
    cold = device_time(fn, kernel, cold=True)
    rec = dict(ms=t["kernel_ms"], device_ms=t["device_ms"], kernel_ms=t["kernel_ms"], wrapper_ms=wrapper_ms,
               device_cold_ms=cold["device_ms"], kernel_cold_ms=cold["kernel_ms"],
               device_launches_per_call=t["device_launches"], trace_attempts=t["attempts"],
               timing="torch.profiler device time, median of 20 calls",
               library_ms=None, library_wrapper_ms=None)
    if lib_fn is not None:
        library_wrapper_ms = time_ms(lib_fn)
        rec.update(library_ms=device_time(lib_fn)["device_ms"], library_wrapper_ms=library_wrapper_ms)
    return rec


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_sorts(fn) -> list[str]:
    """The device kernels of a library sort among what one call of fn launches (torch.profiler)."""
    from transplat_tpu_torch.utils.device_time import device_time

    names = [name for name, _ in device_time(fn)["events"]]
    return sorted({n[:80] for n in names if LIBRARY_SORT.search(n) and not OWN_KERNELS.search(n)})


def deterministic_ops(fn):
    """fn() inside repeatable_ops(): PyTorch's deterministic algorithms, as
    trainer.deterministic_kernels runs its steps (index_add_ then sorts its
    indices on the card)."""
    from transplat_tpu_torch.training.step import repeatable_ops

    with repeatable_ops():
        return fn()


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def scaled_err(a, b) -> float:
    """Max abs error of `a` against `b`, both scaled to b's largest entry."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def require_composite(a, b, label: str) -> tuple[float, float]:
    """The compositing kernel's `a` against its plain version's `b`: all
    values within 1e-5, but for the few pixels where the transmittance
    crosses the 1e-4 gate between two entries. There the kernel's running
    product and the plain version's chunked cumprod can disagree on whether
    one more entry counts; that entry adds at most T alpha c < 1e-4. So:
    at most 1e-4 of the values beyond 1e-5, none beyond 1e-4. Returns (max
    abs error, share beyond 1e-5)."""
    diff = (a.float() - b.float()).abs()
    err, share = float(diff.max()), float((diff > 1e-5).float().mean())
    require(err <= 1e-4 and share <= 1e-4, f"{label}: max abs err {err}, share beyond 1e-5 {share}")
    return err, share


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


def deform_inputs(dev, p: int):
    """K5/K6 inputs at the paths' shapes: 2 directed pairs x 4096 queries, 64x64 maps, D = 128."""
    n, q, d, h, w = 2, 4096, 128, 64, 64
    gen = torch.Generator(device=dev).manual_seed(SEED + p)
    scores = torch.randn((n, q, h * w), device=dev, generator=gen)
    loc = torch.rand((n, q, d, p, 2), device=dev, generator=gen) * 1.2 - 0.1
    loc[:, :, : d // 4] = torch.round(loc[:, :, : d // 4] * w) / w  # exact corner boundaries
    aw = torch.ones((n, q, d, p), device=dev) if p == 1 else torch.softmax(
        torch.randn((n, q, d, p), device=dev, generator=gen), dim=-1
    )
    gbar = torch.randn((n, q, d), device=dev, generator=gen)
    return scores, loc, aw, gbar, (n, q, d, h, w)


def encoder_score_inputs(encoder, ctx, dev, p: int):
    """The inputs of the encoder's first score sampling with P = p, captured
    from one request: at P = 1 the epipolar coarse correlation of the UV
    matcher (locations on the epipolar lines, unit weights), at P = 4 its
    first cross-attention (learned offsets around them). Scores (N, Q, HW),
    locations (N, Q, D, P, 2), weights (N, Q, D, P)."""
    from transplat_tpu_torch.model import uv_transformer

    seen = []
    sample = uv_transformer.deform_sample_scores

    def capture(scores, hw, loc, aw, *args, **kw):
        if loc.shape[-2] == p and not seen:
            seen.append((scores.detach().clone(), tuple(hw), loc.detach().clone(), aw.detach().clone()))
        return sample(scores, hw, loc, aw, *args, **kw)

    uv_transformer.deform_sample_scores = capture
    try:
        with torch.no_grad():
            encoder(*(torch.as_tensor(ctx[k], device=dev) for k in ("image", "intrinsics", "extrinsics", "near", "far")))
    finally:
        uv_transformer.deform_sample_scores = sample
    require(len(seen) == 1, f"the encoder made no P = {p} score sampling")
    scores, (h, w), loc, aw = seen[0]
    n, q, d = loc.shape[0], loc.shape[-4], loc.shape[-3]
    return scores.reshape(n, q, h * w), loc.reshape(n, q, d, p, 2), aw.reshape(n, q, d, p), (n, q, d, h, w)


def check_deform(dev, p: int, launches: dict, inputs=None, label: str = "random locations") -> dict:
    """K5 at the path's shapes (random locations, or the `inputs` given)."""
    from torch.nn import functional as F

    from transplat_tpu_torch.ops import deform
    from transplat_tpu_torch.utils.device_time import device_time

    if inputs is None:
        scores, loc, aw, _, (n, q, d, h, w) = deform_inputs(dev, p)
    else:
        scores, loc, aw, (n, q, d, h, w) = inputs
    out = deform.deform_sample_scores(scores, (h, w), loc, aw)
    ref = deform.deform_sample_scores_plain(scores, (h, w), loc, aw)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    tol = 1e-5
    require(err <= tol, f"deform_scores P={p}: max abs err {err} > {tol}")
    plain_ms = time_ms(lambda: deform.deform_sample_scores_plain(scores, (h, w), loc, aw), iters=5, warmup=1)
    # grid_sample on (N Q, 1, H, W) at the (N Q, D, P) grid, then the weighted
    # sum over P, computes the same function. At P = 1 the yardstick is
    # grid_sample alone, which reads no weights (exact for unit weights).
    grid = (loc * 2.0 - 1.0).reshape(n * q, d, p, 2)
    img = scores.reshape(n * q, 1, h, w)
    sampled = lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False)  # noqa: E731
    weighted = lambda: (sampled().reshape(n, q, d, p) * aw).sum(-1)  # noqa: E731
    lib_fn = sampled if p == 1 else weighted
    # grid_sample maps loc through [-1, 1] and back, so its fractions round
    # differently: 1e-4 of the largest value, as for K7 (on random locations
    # at P = 1 it agrees to 1e-5).
    lib_err = max_err(lib_fn().reshape(n, q, d), ref)
    lib_tol = tol if (p == 1 and inputs is None) else 1e-4 * max(1.0, float(ref.abs().max()))
    require(lib_err <= lib_tol, f"grid_sample disagrees with the plain version: {lib_err} > {lib_tol}")
    times = timings(lambda: deform.deform_sample_scores(scores, (h, w), loc, aw), "deform_scores_kernel", lib_fn)
    if p == 1:
        times["library_with_weights_ms"] = device_time(weighted)["device_ms"]
    samples = n * q * d * p
    sectors = touched_sectors(loc, h, w)
    nbytes = 32 * sectors + 4 * (loc.numel() + aw.numel() + out.numel())
    b_ms, b_by = bound(nbytes, samples * 30.0)
    name = f"deform_scores_p{p}"
    rec = dict(
        name=name, route="cuda", source="transplat_tpu_torch/csrc/deform_scores.cu",
        replaces="transplat_tpu/ops/deform_pallas.py:84", launches=launches.get(name, 0),
        max_abs_err=err, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, **times,
    )
    emit({"phase": "kernel", "inputs": label, "tolerance": tol, "shape": dict(pairs=n, q=q, d=d, p=p, h=h, w=w),
          "score_sectors_touched": sectors, "score_sectors_total": n * q * h * w // 8, **rec})
    return rec


def check_deform_bwd(dev, p: int, inputs=None, label: str = "random locations") -> dict:
    """K6 at the path's shapes (random locations, or the `inputs` given),
    against its plain version and against autograd of the forward's plain
    version; two runs, and a run that asks for determinism, give the same
    bits."""
    from torch.nn import functional as F

    from transplat_tpu_torch.ops import deform

    if inputs is None:
        scores, loc, aw, gbar, (n, q, d, h, w) = deform_inputs(dev, p)
    else:
        scores, loc, aw, (n, q, d, h, w) = inputs
        gbar = torch.randn((n, q, d), device=dev, generator=torch.Generator(device=dev).manual_seed(SEED + 5))
    tol = GRAD_TOL["deform"]
    got = deform._scores_bwd_cuda(scores, (h, w), loc, aw, gbar)
    again = deform._scores_bwd_cuda(scores, (h, w), loc, aw, gbar, deterministic=True)
    require(all(torch.equal(a, b) for a, b in zip(got, again)), f"deform_scores_bwd P={p}: two runs differ")
    plain = deform.deform_sample_scores_bwd_plain(scores, (h, w), loc, aw, gbar)
    leaves = [t.clone().requires_grad_(True) for t in (scores, loc, aw)]
    auto = torch.autograd.grad(deform.deform_sample_scores_plain(leaves[0], (h, w), leaves[1], leaves[2]), leaves, gbar)
    through = torch.autograd.grad(deform.deform_sample_scores(leaves[0], (h, w), leaves[1], leaves[2]), leaves, gbar)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b, c, t in zip(("d_scores", "d_loc", "d_weights"), got, plain, auto, through):
        errs[name] = max(scaled_err(a, b), scaled_err(a, c), scaled_err(t, b))
        require(errs[name] <= tol, f"deform_scores_bwd P={p} {name}: scaled max abs err {errs[name]} > {tol}")
    plain_ms = time_ms(lambda: deform.deform_sample_scores_bwd_plain(scores, (h, w), loc, aw, gbar), iters=5, warmup=1)
    # The library's way: autograd's backward of grid_sample + the weighted sum
    # (input, grid and weight gradients).
    grid = (loc * 2.0 - 1.0).reshape(n * q, d, p, 2).requires_grad_(True)
    img = scores.reshape(n * q, 1, h, w).clone().requires_grad_(True)
    lib_aw = aw.clone().requires_grad_(True)
    lib = (F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False).reshape(n, q, d, p) * lib_aw).sum(-1)
    lib_img, lib_grid, lib_daw = torch.autograd.grad(lib, (img, grid, lib_aw), gbar, retain_graph=True)
    lib_tol = tol if (p == 1 and inputs is None) else 1e-4  # as in check_deform
    require(scaled_err(lib_img.reshape(n, q, h * w), plain[0]) <= lib_tol, "grid_sample's d_input disagrees with the plain version")
    require(scaled_err(lib_grid.reshape(n, q, d, p, 2) * 2.0, plain[1]) <= lib_tol, "grid_sample's d_grid disagrees with the plain version")
    require(scaled_err(lib_daw, plain[2]) <= lib_tol, "the weighted sum's d_weights disagrees with the plain version")
    times = timings(lambda: deform._scores_bwd_cuda(scores, (h, w), loc, aw, gbar), "deform_scores_bwd_kernel",
                    lambda: torch.autograd.grad(lib, (img, grid, lib_aw), gbar, retain_graph=True))
    sectors = touched_sectors(loc, h, w)
    nbytes = 32 * sectors + 4 * (loc.numel() + aw.numel() + gbar.numel()) + 4 * sum(t.numel() for t in got)
    b_ms, b_by = bound(nbytes, n * q * d * p * 60.0)
    name = f"deform_scores_bwd_p{p}"
    rec = dict(
        name=name, route="cuda", source="transplat_tpu_torch/csrc/deform_scores_bwd.cu",
        replaces="transplat_tpu/ops/deform_pallas.py:133", launches=0,
        max_abs_err=max(errs.values()), plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, **times,
    )
    emit({"phase": "kernel", "inputs": label, "tolerance": tol,
          "error_is": "max abs, values scaled to the gradient's largest entry", "errors": errs,
          "bit_identical_runs": True, "path": deform.scores_bwd_plan(h, w, d, p),
          "shape": dict(pairs=n, q=q, d=d, p=p, h=h, w=w), "bytes": nbytes, **rec})
    return rec


def check_deform_bwd_general(dev) -> None:
    """K6 at a shape whose gradient row does not fit in shared memory (its
    general path, device-memory atomics): against its plain version; asking
    for determinism there raises."""
    from transplat_tpu_torch.ops import deform

    n, q, d, p, h, w = 1, 8, 4, 2, 256, 256
    require(deform.scores_bwd_plan(h, w, d, p) == "general", "the general-path shape fits in shared memory")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    scores = torch.randn((n, q, h * w), device=dev, generator=gen)
    loc = torch.rand((n, q, d, p, 2), device=dev, generator=gen) * 1.2 - 0.1
    aw = torch.rand((n, q, d, p), device=dev, generator=gen)
    gbar = torch.randn((n, q, d), device=dev, generator=gen)
    got = deform._scores_bwd_cuda(scores, (h, w), loc, aw, gbar)
    plain = deform.deform_sample_scores_bwd_plain(scores, (h, w), loc, aw, gbar)
    torch.cuda.synchronize()
    errs = {name: scaled_err(a, b) for name, a, b in zip(("d_scores", "d_loc", "d_weights"), got, plain)}
    require(max(errs.values()) <= GRAD_TOL["deform"], f"deform_scores_bwd general path: {errs}")
    try:
        deform._scores_bwd_cuda(scores, (h, w), loc, aw, gbar, deterministic=True)
        refused = False
    except ValueError:
        refused = True
    require(refused, "deform_scores_bwd: the general path ran where determinism was asked for")
    emit({"phase": "deform_scores_bwd_general", "shape": dict(pairs=n, q=q, d=d, p=p, h=h, w=w), "errors": errs,
          "tolerance": GRAD_TOL["deform"], "deterministic_refused": True})


def vectors_inputs(dev):
    """K7/K8 inputs at the paths' shape: 2 directed pairs x 4096 queries of a
    64x64 map, C = 128, P = 4. Locations are the pixel centres plus small
    random offsets, as the self-attention produces them; an eighth sits on
    exact corner boundaries, an eighth around and outside the map's edge and a
    few far outside."""
    n, h, w, c, p = 2, 64, 64, 128, 4
    q = h * w
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    value = torch.randn((n, h * w, c), device=dev, generator=gen)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    centres = torch.stack([(xs + 0.5) / w, (ys + 0.5) / h], dim=-1).reshape(1, q, 1, 2)
    loc = centres + torch.randn((n, q, p, 2), device=dev, generator=gen) * (1.5 / w)
    loc[:, : q // 8] = torch.round(loc[:, : q // 8] * w) / w  # exact corner boundaries
    loc[:, q // 8 : q // 4] = torch.rand((n, q // 8, p, 2), device=dev, generator=gen) * 1.2 - 0.1
    loc[:, q // 4 : q // 4 + 16] = loc[:, q // 4 : q // 4 + 16] * 1e6  # far outside
    aw = torch.softmax(torch.randn((n, q, p), device=dev, generator=gen), dim=-1)
    gbar = torch.randn((n, q, c), device=dev, generator=gen)
    return value, loc.contiguous(), aw, gbar, (n, q, h, w, c, p)


def vectors_rows_touched(loc: torch.Tensor, n: int, h: int, w: int) -> int:
    """Rows of the value maps that the in-range corners of `loc` (N, Q, P, 2) hit."""
    px = torch.floor(loc[..., 0] * w - 0.5).clamp(-2.0, w + 1.0).long()
    py = torch.floor(loc[..., 1] * h - 0.5).clamp(-2.0, h + 1.0).long()
    pair = torch.arange(n, device=loc.device).reshape(n, 1, 1)
    hit = torch.zeros(n * h * w + 1, dtype=torch.bool, device=loc.device)
    for dy in (0, 1):
        for dx in (0, 1):
            ix, iy = px + dx, py + dy
            inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            hit[torch.where(inside, pair * h * w + iy * w + ix, n * h * w).reshape(-1)] = True
    return int(hit[:-1].sum())


def _grid_sample_vectors(value, loc, aw, shape):
    """The library's way to the same function: grid_sample on V as (N, C, H, W)
    with the Q x P grid, then the weighted sum over the points."""
    from torch.nn import functional as F

    n, q, h, w, c, p = shape
    img = value.reshape(n, h, w, c).permute(0, 3, 1, 2)
    sampled = F.grid_sample(img, loc * 2.0 - 1.0, mode="bilinear", padding_mode="zeros", align_corners=False)
    return torch.einsum("ncqp,nqp->nqc", sampled, aw)


def check_deform_vectors(dev, launches: dict) -> dict:
    """K7 at the path's shape against its plain version and grid_sample."""
    from transplat_tpu_torch.ops import deform

    value, loc, aw, _, shape = vectors_inputs(dev)
    n, q, h, w, c, p = shape
    tol = 1e-5
    out = deform.deform_sample_vectors(value, (h, w), loc, aw)
    ref = deform.deform_sample_vectors_plain(value, (h, w), loc, aw)
    lib = _grid_sample_vectors(value, loc, aw, shape)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    require(bool(torch.isfinite(out).all()) and err <= tol, f"deform_vectors: max abs err {err} > {tol}")
    # grid_sample maps loc through [-1, 1] and back, so its fractions round differently: 1e-4.
    require(max_err(lib, ref) <= 1e-4, "grid_sample disagrees with the plain value sampler")
    plain_ms = time_ms(lambda: deform.deform_sample_vectors_plain(value, (h, w), loc, aw), iters=5, warmup=1)
    times = timings(lambda: deform.deform_sample_vectors(value, (h, w), loc, aw), "deform_vectors_kernel",
                    lambda: _grid_sample_vectors(value, loc, aw, shape))
    rows = vectors_rows_touched(loc, n, h, w)
    nbytes = 4 * (rows * c + loc.numel() + aw.numel() + out.numel())
    b_ms, b_by = bound(nbytes, n * q * p * 4 * (2.0 * c + 12.0))
    rec = dict(
        name="deform_vectors", route="cuda", source="transplat_tpu_torch/csrc/deform_vectors.cu",
        replaces="transplat_tpu/ops/deform_pallas.py:347", launches=launches.get("deform_vectors", 0),
        max_abs_err=err, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, **times,
    )
    emit({"phase": "kernel", "tolerance": tol, "shape": dict(pairs=n, q=q, c=c, p=p, h=h, w=w),
          "value_rows_touched": rows, "value_rows_total": n * h * w, "bytes": nbytes, **rec})
    return rec


def window_share(loc: torch.Tensor, h: int, w: int) -> float:
    """Share of the in-map corners of `loc` (N, Q = H W, P, 2) that fall in
    their query's K8 window (the 8x8 pixel tile plus 4 cells on each side),
    which K8's atomic mode adds in shared memory."""
    px = torch.floor(loc[..., 0] * w - 0.5).clamp(-2.0, w + 1.0).long()
    py = torch.floor(loc[..., 1] * h - 0.5).clamp(-2.0, h + 1.0).long()
    qi = torch.arange(h * w, device=loc.device).reshape(1, -1, 1)
    x0, y0 = (qi % w) // 8 * 8 - 4, (qi // w) // 8 * 8 - 4
    inside = window = 0
    for dy in (0, 1):
        for dx in (0, 1):
            ix, iy = px + dx, py + dy
            in_map = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            in_win = in_map & (ix >= x0) & (ix < x0 + 16) & (iy >= y0) & (iy < y0 + 16)
            inside += int(in_map.sum())
            window += int(in_win.sum())
    return window / max(inside, 1)


def check_deform_vectors_bwd(dev) -> list[dict]:
    """K8 (atomic and sorted mode) at the path's shape, against its plain
    version, against autograd of the forward's plain version, and through the
    Function; the sorted mode twice for identical bits. One record per mode."""
    from transplat_tpu_torch.ops import deform

    value, loc, aw, gbar, shape = vectors_inputs(dev)
    n, q, h, w, c, p = shape
    tol = GRAD_TOL["deform"]
    plain = deform.deform_sample_vectors_bwd_plain(value, (h, w), loc, aw, gbar)
    leaves = [t.clone().requires_grad_(True) for t in (value, loc, aw)]
    auto = torch.autograd.grad(deform.deform_sample_vectors_plain(leaves[0], (h, w), leaves[1], leaves[2]), leaves, gbar)
    errs = {}
    for mode, deterministic in (("atomic", False), ("sorted", True)):
        through = torch.autograd.grad(
            deform.deform_sample_vectors(leaves[0], (h, w), leaves[1], leaves[2], deterministic=deterministic), leaves, gbar
        )
        got = deform._vectors_bwd_cuda(value, (h, w), loc, aw, gbar, deterministic=deterministic)
        torch.cuda.synchronize()
        for name, a, b, cc, t in zip(("d_value", "d_loc", "d_weights"), got, plain, auto, through):
            require(bool(torch.isfinite(a).all()), f"deform_vectors_bwd ({mode}) {name}: non-finite")
            errs[f"{mode}.{name}"] = max(scaled_err(a, b), scaled_err(a, cc), scaled_err(t, b))
        far = slice(q // 4, q // 4 + 16)  # every corner outside the map: exactly 0
        require(float(got[1][:, far].abs().max()) == 0.0 and float(got[2][:, far].abs().max()) == 0.0,
                f"deform_vectors_bwd ({mode}): gradients of points far outside the map are not 0")
    for name, e in errs.items():
        require(e <= tol, f"deform_vectors_bwd {name}: scaled max abs err {e} > {tol}")
    first = deform._vectors_bwd_cuda(value, (h, w), loc, aw, gbar, deterministic=True)
    second = deform._vectors_bwd_cuda(value, (h, w), loc, aw, gbar, deterministic=True)
    require(all(torch.equal(x, y) for x, y in zip(first, second)), "deform_vectors_bwd sorted mode is not deterministic")
    # The sorted mode's order, the counting sort, against torch.sort's (and the
    # plain version), and its d_value against the route that took torch.sort's
    # order (kept as a plain composition) bit for bit; no library sort inside.
    keys, corner_w, _, _ = deform._vectors_bwd_launch(value, (h, w), loc, aw, gbar, True)
    rows = n * h * w
    order = deform.vectors_bwd_order(keys, n, h * w)
    by_sort = deform.vectors_bwd_order_by_sort(keys, rows)
    require(all(torch.equal(x, y) for x, y in zip(order, by_sort))
            and all(torch.equal(x, y) for x, y in zip(deform.vectors_bwd_order_plain(keys, rows), by_sort)),
            "deform_vectors_bwd_order: not torch.sort's permutation and segments")
    sort_route = deform.vectors_bwd_sorted_plain(gbar, corner_w, *by_sort, 4 * p)
    require(torch.equal(first[0].reshape(sort_route.shape), sort_route)
            and torch.equal(deform.vectors_bwd_sorted(gbar, corner_w, *by_sort, 4 * p), sort_route),
            "deform_vectors_bwd sorted mode: other bits than torch.sort's route")
    edge = []
    for nn, qq, pp, hh, ww in ((3, 100, 4, 5, 7), (2, 8192, 4, 128, 160), (1, 64, 2, 1, 1)):
        # 35 cells; 20,481 cells a batch entry, four histogram slices; one cell, most corners outside.
        gl = torch.Generator(device=dev).manual_seed(SEED + hh)
        lk, _ = deform.vectors_bwd_keys_plain(torch.rand((nn, qq, pp, 2), device=dev, generator=gl) * 1.4 - 0.2,
                                              torch.rand((nn, qq, pp), device=dev, generator=gl), hh, ww)
        require(all(torch.equal(x, y) for x, y in zip(deform.vectors_bwd_order(lk, nn, hh * ww),
                                                      deform.vectors_bwd_order_by_sort(lk, nn * hh * ww))),
                f"deform_vectors_bwd_order: not torch.sort's on {nn} x {hh}x{ww} maps")
        edge.append(dict(n=nn, h=hh, w=ww, corners=lk.numel(), outside=int((lk == nn * hh * ww).sum())))
    sorts = library_sorts(lambda: deform._vectors_bwd_cuda(value, (h, w), loc, aw, gbar, deterministic=True))
    witness = library_sorts(lambda: deform.vectors_bwd_order_by_sort(keys, rows))
    require(not sorts and witness, f"deform_vectors_bwd sorted mode launches library sorts {sorts} (torch.sort's: {witness})")
    emit({"phase": "sorted_order_check", "kernel": "deform_vectors_bwd_order", "equal_to_torch_sort": True,
          "same_bits_as_torch_sort_route": True, "library_sort_kernels": sorts,
          "library_sort_kernels_of_torch_sort": witness, "edge_cases_equal_to_torch_sort": edge})
    plain_ms = time_ms(lambda: deform.deform_sample_vectors_bwd_plain(value, (h, w), loc, aw, gbar), iters=5, warmup=1)
    lib_leaves = [t.clone().requires_grad_(True) for t in (value, loc, aw)]
    lib = _grid_sample_vectors(*lib_leaves, shape)
    lib_grads = torch.autograd.grad(lib, lib_leaves, gbar, retain_graph=True)
    for name, a, b in zip(("d_value", "d_loc", "d_weights"), lib_grads, plain):
        require(scaled_err(a, b) <= 1e-4, f"grid_sample's {name} disagrees with the plain version")
    lib_fn = lambda: torch.autograd.grad(lib, lib_leaves, gbar, retain_graph=True)  # noqa: E731
    # The plain forward's autograd backward (advanced indexing), which the kernel took off the training step.
    auto_out = deform.deform_sample_vectors_plain(leaves[0], (h, w), leaves[1], leaves[2])
    autograd_ms = time_ms(lambda: torch.autograd.grad(auto_out, leaves, gbar, retain_graph=True), iters=5, warmup=1)
    touched = vectors_rows_touched(loc, n, h, w)
    nbytes = 4 * (touched * c + loc.numel() + aw.numel() + gbar.numel() + value.numel() + loc.numel() + aw.numel())
    b_ms, b_by = bound(nbytes, n * q * p * 4 * (4.0 * c + 20.0))
    # The library's deterministic way to the sorted mode's d_value: index_add_
    # of the corner rows under torch.use_deterministic_algorithms.
    inside = keys < rows
    contrib = corner_w[inside, None] * gbar.reshape(-1, c)[torch.nonzero(inside).squeeze(1) // (4 * p)]
    det_lib = lambda: deterministic_ops(  # noqa: E731
        lambda: torch.zeros((rows, c), device=dev).index_add_(0, keys[inside].long(), contrib))
    require(scaled_err(det_lib(), sort_route) <= tol, "deterministic index_add_ disagrees with the sorted mode")
    records = []
    for name, deterministic, kernel, library in (("deform_vectors_bwd", False, "deform_vectors_bwd_kernel", lib_fn),
                                                 ("deform_vectors_bwd_sorted", True, "deform_vectors_bwd", det_lib)):
        mode = "sorted" if deterministic else "atomic"
        rec = dict(
            name=name, route="cuda", source="transplat_tpu_torch/csrc/deform_vectors_bwd.cu",
            replaces="transplat_tpu/ops/deform_pallas.py:361", launches=0,
            max_abs_err=max(e for k, e in errs.items() if k.startswith(mode)), plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by,
            **timings(lambda: deform._vectors_bwd_cuda(value, (h, w), loc, aw, gbar, deterministic=deterministic),
                      kernel, library),
            plain_forward_autograd_ms=autograd_ms,
        )
        if deterministic:
            rec["kernel_is"] = "all five hand-written kernels: corner keys, count, scan, place, row sums"
            rec["library_is"] = "index_add_ of the in-map corner rows under torch.use_deterministic_algorithms"
        emit({"phase": "kernel", "mode": mode, "tolerance": tol,
              "error_is": "max abs, values scaled to the gradient's largest entry", "errors": errs,
              "corners_in_window_share": window_share(loc, h, w), "sorted_bit_identical_runs": True,
              "shape": dict(pairs=n, q=q, c=c, p=p, h=h, w=w), "bytes": nbytes, **rec})
        records.append(rec)
    # The counting sort alone: the keys read once, perm and offsets written once.
    o_ms, o_by = bound(4 * (2 * keys.numel() + rows + 2), 0.0)
    rec = dict(
        name="deform_vectors_bwd_order", route="cuda", source="transplat_tpu_torch/csrc/deform_vectors_bwd.cu",
        replaces="transplat_tpu/ops/deform_pallas.py:361", launches=0, max_abs_err=0.0,
        plain_ms=time_ms(lambda: deform.vectors_bwd_order_plain(keys, rows), iters=3, warmup=1),
        bound_ms=o_ms, bound_by=o_by,
        **timings(lambda: deform.vectors_bwd_order(keys, n, h * w), "deform_vectors_bwd",
                  lambda: torch.sort(keys, stable=True)),
        kernel_is="count, scan and place (a stable counting sort of the corner keys)",
        library_is="torch.sort(keys, stable=True): the permutation alone",
    )
    emit({"phase": "kernel", "mode": "sorted", "equal_to_torch_sort": True, "corners": keys.numel(),
          "outside_the_map": int((~inside).sum()), "shape": dict(pairs=n, q=q, c=c, p=p, h=h, w=w), **rec})
    records.append(rec)
    return records


# The operations K3 and K4 need (`needed_bound_ms`, beside `bound_ms`, which
# charges 20 + 2C and 59 + 4C to every evaluation): the evaluation (16 of
# those: dx, dy, power, exp, alpha and the keep test) on the (pixel, entry)
# pairs whose warp cannot cull the entry, and what follows it on the pairs that
# keep the entry only: K3's blend (4 + 2C), K4's blend and gradient chain
# (43 + 4C). Counts from raster_report.needed_work on this run's lists.
NEEDED_OPS = {"composite": (16.0, lambda c: 4.0 + 2 * c), "composite_bwd": (16.0, lambda c: 43.0 + 4 * c)}


def check_binning(gfeat, image_shape, tile: int, label: str) -> dict:
    """K1 on depth-sorted rows: each of its three kernels equal to its plain
    version (torch.equal), and the whole, bin_gaussians, equal to
    bin_gaussians_plain (the classic route: a key per pair, torch.sort,
    each run's ends). Returns the pieces for timing."""
    from transplat_tpu_torch.ops.rasterizer import binning

    b, g, _ = gfeat.shape
    ntx, nty = binning.grid_size(image_shape, tile)
    table, rects, aux = binning.bin_count(gfeat, ntx, nty, tile)
    table_p, rects_p, aux_p = binning.bin_count_plain(gfeat, ntx, nty, tile)
    require(torch.equal(table, table_p) and torch.equal(rects, rects_p), f"{label}: bin_count != plain")
    bases, bases_p = table.clone(), table.clone()
    ranges = binning.bin_scan(bases, aux)
    ranges_p = binning.bin_scan_plain(bases_p, aux_p)
    require(torch.equal(bases, bases_p) and torch.equal(ranges, ranges_p) and torch.equal(aux[0], aux_p[0]),
            f"{label}: bin_scan != plain")
    total = int(aux[0])
    idx = binning.bin_place(rects, bases, ranges, total, ntx, nty)
    require(torch.equal(idx, binning.bin_place_plain(rects, bases, ranges, total, ntx, nty)), f"{label}: bin_place != plain")
    lists = binning.bin_gaussians(gfeat, image_shape, tile)
    ref = binning.bin_gaussians_plain(gfeat, image_shape, tile)
    require(torch.equal(lists.idx, ref.idx) and torch.equal(lists.ranges, ref.ranges) and torch.equal(lists.idx, idx),
            f"{label}: bin_gaussians != bin_gaussians_plain")
    # K2's deterministic order, read off the lists' rectangles, against torch.sort's.
    require(torch.equal(lists.rects, ref.rects)
            and all(torch.equal(x, y) for x, y in zip(binning.bin_bwd_order(lists, b, g),
                                                      binning.bin_bwd_order_by_sort(lists, b, g))),
            f"{label}: bin_bwd_order != torch.sort's order")
    emit({"phase": "binning_check", "scene": label, "views": b, "gaussians": g, "h": image_shape[0], "w": image_shape[1],
          "tile": tile, "tiles_per_view": ntx * nty, "chunks": table.shape[-1], "pairs": total,
          "empty_views": int(((ranges[:, 1] - ranges[:, 0]).reshape(b, -1).sum(1) == 0).sum()),
          "equal_to_plain": True, "equal_to_sorted_route": True, "bwd_order_equal_to_torch_sort": True})
    return dict(table=table, rects=rects, aux=aux, bases=bases, ranges=ranges, total=total, lists=lists, ref=ref,
                ntx=ntx, nty=nty)


def check_binning_scenes(dev) -> None:
    """K1 beyond the request: synthetic scenes with a dead-heavy view and an
    all-dead one, a grid wider than one shared-memory histogram (1024^2 at
    tile 8: 16,384 tiles a view), Gaussians that cover every tile, a count
    of Gaussians that is not a multiple of the chunk, and no pairs at all."""
    from transplat_tpu_torch.ops.rasterizer import api, binning

    cams, gs = synthetic_scene(131072 + 77, 4, dev, SEED + 4)
    with torch.no_grad():
        for shape, tile in (((256, 256), 16), ((1024, 1024), 8)):
            gfeat, _ = binning.sort_by_depth(api.project_views(*cams[:2], cams[2], *gs, shape))
            check_binning(gfeat, shape, tile, f"synthetic_{shape[0]}_tile{tile}")
            dead = gfeat.clone()
            kill = torch.rand(dead.shape[:2], device=dev, generator=torch.Generator(device=dev).manual_seed(SEED)) < 0.9
            kill[1] = True  # a view with no live Gaussian
            dead[kill] = torch.tensor([1e9, 1e9, 0, 0, 0, 0, 0, 0], device=dev)
            check_binning(dead, shape, tile, f"dead_heavy_{shape[0]}_tile{tile}")
            big = gfeat.clone()
            big[:, :40, 2:7] = torch.tensor([1e-8, 0.0, 1e-8, 1e4, 0.9], device=dev)  # cover every tile
            check_binning(big, shape, tile, f"cover_all_{shape[0]}_tile{tile}")
        none = gfeat.clone()
        none[..., 5] = 0.0
        check_binning(none, (1024, 1024), 8, "no_pairs")


def bin_gaussians_record(gfeat, image_shape, total: int, cells: int, table_bytes: int) -> dict:
    """The whole of K1 on the request: device time of one bin_gaussians call
    (its three kernels and the host read of the number of pairs), warm and
    cold, against the bound of the function (the rows read once, idx, ranges
    and the count table written once) and the classic route on the card
    (bin_gaussians_plain: a key per pair, torch.sort, the runs' ends)."""
    from transplat_tpu_torch.ops.rasterizer import binning
    from transplat_tpu_torch.utils.device_time import device_time

    with torch.no_grad():
        t = timings(lambda: binning.bin_gaussians(gfeat, image_shape), "bin_",
                    lambda: binning.bin_gaussians_plain(gfeat, image_shape))
        parts = device_time(lambda: binning.bin_gaussians(gfeat, image_shape), cold=True)["events"]
    nbytes = 4 * gfeat.numel() + 4 * total + 8 * cells + table_bytes
    b_ms, b_by = bound(nbytes, 0.0)
    rec = {"phase": "bin_gaussians", "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "pairs": total,
           "parts_cold_ms": [[name[:60], ms] for name, ms in parts],
           "kernel_is": "bin_count + bin_scan + bin_place; device_ms adds the host read's copy",
           "library_is": "bin_gaussians_plain: the classic route in PyTorch ops (torch.sort)", **t}
    emit(rec)
    return rec


def check_raster(proj, image_shape, launches: dict, label: str, timed: bool) -> list[dict]:
    """K1 (bin_count, bin_scan, bin_place) and K3 (composite) against their
    plain versions on one set of projected Gaussians; K3, K4 and K2's sorted
    mode give the same bits on K1's lists as on the classic route's."""
    from transplat_tpu_torch import raster_report
    from transplat_tpu_torch.ops.rasterizer import binning, composite

    gfeat, colors = binning.sort_by_depth(proj)
    b, g, _ = gfeat.shape
    k1 = check_binning(gfeat, image_shape, 16, label)
    lists, ref_lists, total = k1["lists"], k1["ref"], k1["total"]
    ntx, nty = k1["ntx"], k1["nty"]
    cells = b * ntx * nty
    bg = torch.zeros((b, colors.shape[-1]), device=gfeat.device)
    img = composite.composite_tiles(gfeat, colors, lists, bg, image_shape)
    img_p, _, evaluations = composite.composite_tiles_plain(gfeat, colors, lists, bg, image_shape)
    torch.cuda.synchronize()
    err, share = require_composite(img, img_p, f"{label}: composite")
    sizes = dict(views=b, gaussians=g, pairs=total, h=image_shape[0], w=image_shape[1])
    emit({"phase": "raster_check", "scene": label, "composite_max_abs_err": err, "composite_share_beyond_1e-5": share,
          "tolerance": "1e-5; at most 1e-4 of the values up to 1e-4 (entries at the T = 1e-4 gate)",
          "binning_exact": True, "evaluations": evaluations, **sizes})

    # Backward: K4 and K2 with a random d out and a non-black background.
    c = colors.shape[-1]
    gen = torch.Generator(device=gfeat.device).manual_seed(SEED + 7)
    bg_b = torch.rand((b, c), device=gfeat.device, generator=gen)
    g_out = torch.randn((b, *image_shape, c), device=gfeat.device, generator=gen)
    # A training step's forward and K4 take the tiles longest list first.
    order = composite.tile_order(lists)
    image, t_final = composite._composite_fwd_cuda(gfeat, colors, lists, bg_b, image_shape, order=order)
    image_p, t_final_p, _ = composite.composite_tiles_plain(gfeat, colors, lists, bg_b, image_shape)
    require_composite(image, image_p, f"{label}: composite, coloured background")
    require_composite(t_final, t_final_p, f"{label}: T_final")
    d_pair = composite._composite_bwd_cuda(gfeat, colors, lists, bg_b, image, t_final, g_out, order=order)
    d_pair_p = composite.composite_tiles_bwd_plain(gfeat, colors, lists, bg_b, image_p, t_final_p, g_out)
    again = composite._composite_bwd_cuda(gfeat, colors, lists, bg_b, image, t_final, g_out, order=order)
    require(torch.equal(d_pair, again), f"{label}: two composite_bwd runs differ (K4 must be deterministic)")
    k4_errs = {
        name: scaled_err(d_pair[:, lo:hi], d_pair_p[:, lo:hi])
        for name, lo, hi in (("d_mean", 0, 2), ("d_conic", 2, 5), ("d_opacity", 6, 7), ("d_colour", 8, 8 + c))
    }
    for name, e in k4_errs.items():
        require(e <= GRAD_TOL["composite"], f"{label}: composite_bwd {name}: scaled max abs err {e} > {GRAD_TOL['composite']}")
    require(float(d_pair[:, 5].abs().max()) == 0.0 and float(d_pair[:, 7].abs().max()) == 0.0
            and float(d_pair[:, 8 + c :].abs().sum()) == 0.0, f"{label}: a radius or pad column of d_pair is not 0")
    ref_g, ref_c = binning.bin_bwd_plain(d_pair, lists, b, g, c)
    k2_errs = {}
    for mode, deterministic in (("atomic", False), ("sorted", True)):
        got_g, got_c = binning.bin_bwd(d_pair, lists, b, g, c, deterministic=deterministic)
        k2_errs[mode] = max(scaled_err(got_g, ref_g), scaled_err(got_c, ref_c))
        require(k2_errs[mode] <= GRAD_TOL["bin"], f"{label}: bin_bwd ({mode}): scaled max abs err {k2_errs[mode]} > {GRAD_TOL['bin']}")
    first = binning.bin_bwd(d_pair, lists, b, g, c, deterministic=True)
    second = binning.bin_bwd(d_pair, lists, b, g, c, deterministic=True)
    require(all(torch.equal(x, y) for x, y in zip(first, second)), f"{label}: bin_bwd sorted mode is not deterministic")
    # The classic route's lists (a key per pair, torch.sort) give K3, K4 and
    # K2's sorted mode the same inputs, so the same bits.
    ref_order = composite.tile_order(ref_lists)
    ref_image, ref_t = composite._composite_fwd_cuda(gfeat, colors, ref_lists, bg_b, image_shape, order=ref_order)
    ref_d_pair = composite._composite_bwd_cuda(gfeat, colors, ref_lists, bg_b, ref_image, ref_t, g_out, order=ref_order)
    same = (torch.equal(img, composite.composite_tiles(gfeat, colors, ref_lists, bg, image_shape))
            and torch.equal(image, ref_image) and torch.equal(t_final, ref_t) and torch.equal(d_pair, ref_d_pair)
            and all(torch.equal(x, y) for x, y in zip(first, binning.bin_bwd(ref_d_pair, ref_lists, b, g, c, deterministic=True))))
    require(same, f"{label}: K3, K4 or K2 give other bits on the classic route's lists")
    torch.cuda.synchronize()
    # K2's deterministic order against torch.sort's (and its plain version), its
    # output against the route that took torch.sort's order (kept as a plain
    # composition) bit for bit; no library sort inside the wrapper.
    by_sort = binning.bin_bwd_order_by_sort(lists, b, g)
    require(all(torch.equal(x, y) for x, y in zip(binning.bin_bwd_order(lists, b, g), by_sort))
            and all(torch.equal(x, y) for x, y in zip(binning.bin_bwd_order_plain(lists, b, g), by_sort)),
            f"{label}: bin_bwd_order: not torch.sort's permutation and segments")
    sort_route = binning.bin_bwd_sorted_plain(d_pair, *by_sort)
    require(all(torch.equal(x, y) for x, y in zip(first, binning.split_rows(sort_route, b, g, c)))
            and torch.equal(binning.bin_bwd_sorted(d_pair, *by_sort), sort_route),
            f"{label}: bin_bwd sorted mode: other bits than torch.sort's route")
    sorts = library_sorts(lambda: binning.bin_bwd(d_pair, lists, b, g, c, deterministic=True))
    witness = library_sorts(lambda: binning.bin_bwd_order_by_sort(lists, b, g))
    require(not sorts and witness, f"{label}: bin_bwd sorted mode launches library sorts {sorts} (torch.sort's: {witness})")
    emit({"phase": "sorted_order_check", "kernel": "bin_bwd_order", "scene": label, "equal_to_torch_sort": True,
          "same_bits_as_torch_sort_route": True, "library_sort_kernels": sorts,
          "library_sort_kernels_of_torch_sort": witness})
    emit({"phase": "raster_bwd_check", "scene": label, "tolerance": GRAD_TOL,
          "error_is": "max abs, values scaled to the gradient's largest entry",
          "composite_bwd_errors": k4_errs, "composite_bwd_bit_identical_runs": True, "bin_bwd_errors": k2_errs,
          "same_bits_as_sorted_route": ["composite", "composite_bwd", "bin_bwd_sorted"], **sizes})
    if not timed:
        return []
    srcs = dict(bin="transplat_tpu_torch/csrc/binning.cu", comp="transplat_tpu_torch/csrc/composite.cu")
    k1_tpu = "transplat_tpu/ops/rasterizer/pallas_binning.py:276"
    k3 = "transplat_tpu/ops/rasterizer/pallas_composite.py:160"
    pair_rows = binning._pair_rows(lists, b, g)
    table_bytes = 4 * k1["table"].numel()

    def scan_once():
        aux = k1["aux"].clone()
        aux[1] = 0  # bin_count zeroes the scan's count of finished blocks
        return binning.bin_scan(k1["table"].clone(), aux)

    bin_gaussians_record(gfeat, image_shape, total, cells, table_bytes)
    recs = []
    # name, source, TPU kernel, error, wrapper, plain version, library call, bytes, operations, kernel name
    specs = [
        # K1's kernels: the rows in, the count table and the packed rectangles out;
        # the table scanned in place and the ranges out; the rectangles, bases
        # and ranges in and idx out. None of them equals one library call.
        ("bin_count", srcs["bin"], k1_tpu, 0.0,
         lambda: binning.bin_count(gfeat, ntx, nty, 16), lambda: binning.bin_count_plain(gfeat, ntx, nty, 16), None,
         4 * gfeat.numel() + table_bytes + 8 * b * g, b * g * 40.0, "bin_count_kernel"),
        ("bin_scan", srcs["bin"], k1_tpu, 0.0, scan_once,
         lambda: binning.bin_scan_plain(k1["table"].clone(), k1["aux"].clone()), None,
         2 * table_bytes + 8 * cells, table_bytes / 2.0, "bin_scan_kernel"),
        ("bin_place", srcs["bin"], k1_tpu, 0.0,
         lambda: binning.bin_place(k1["rects"], k1["bases"], k1["ranges"], total, ntx, nty),
         lambda: binning.bin_place_plain(k1["rects"], k1["bases"], k1["ranges"], total, ntx, nty), None,
         8 * b * g + table_bytes + 8 * cells + 4 * total, 10.0 * total, "bin_place_kernel"),
        ("composite", srcs["comp"], k3, err,
         lambda: composite.composite_tiles(gfeat, colors, lists, bg, image_shape),
         lambda: composite.composite_tiles_plain(gfeat, colors, lists, bg, image_shape), None,
         4 * (gfeat.numel() + colors.numel() + total + 2 * cells + bg.numel() + img.numel()),
         evaluations * (20.0 + 2 * colors.shape[-1]), "composite_kernel"),
        # K4: the forward's evaluations, each with the gradient chain (~59 +
        # 4C operations: the forward's 20, <g, c>, d_alpha, the seven products,
        # and one add per value for the sum over pixels).
        ("composite_bwd", "transplat_tpu_torch/csrc/composite_bwd.cu",
         "transplat_tpu/ops/rasterizer/pallas_composite.py:250", max(k4_errs.values()),
         lambda: composite._composite_bwd_cuda(gfeat, colors, lists, bg_b, image, t_final, g_out, order=order),
         lambda: composite.composite_tiles_bwd_plain(gfeat, colors, lists, bg_b, image_p, t_final_p, g_out), None,
         4 * (gfeat.numel() + colors.numel() + total + 2 * cells + bg_b.numel() + 2 * image.numel()
              + t_final.numel() + total * (8 + c)),
         evaluations * (59.0 + 4 * c), "composite_bwd_kernel"),
        # K2 (atomic mode, the one on the path): d_pair and idx in, (B, G, 8 + C) out
        # (the bound counts 8 + C columns, not the padded row).
        ("bin_bwd", "transplat_tpu_torch/csrc/binning_bwd.cu",
         "transplat_tpu/ops/rasterizer/pallas_binning.py:457", k2_errs["atomic"],
         lambda: binning.bin_bwd(d_pair, lists, b, g, c),
         lambda: binning.bin_bwd_plain(d_pair, lists, b, g, c),
         lambda: torch.zeros((b * g, d_pair.shape[1]), device=d_pair.device).index_add_(0, pair_rows, d_pair),
         4 * (total * (8 + c) + total + b * g * (8 + c)), float(total * (8 + c)), "bin_bwd_atomic_kernel"),
        # K2's sorted, deterministic mode: its order (two kernels) and the
        # segment sums; the library's deterministic index_add_ beside it.
        ("bin_bwd_sorted", "transplat_tpu_torch/csrc/binning_bwd.cu",
         "transplat_tpu/ops/rasterizer/pallas_binning.py:457", k2_errs["sorted"],
         lambda: binning.bin_bwd(d_pair, lists, b, g, c, deterministic=True),
         lambda: binning.bin_bwd_sorted_plain(d_pair, *binning.bin_bwd_order_plain(lists, b, g)),
         lambda: deterministic_ops(
             lambda: torch.zeros((b * g, d_pair.shape[1]), device=d_pair.device).index_add_(0, pair_rows, d_pair)),
         4 * (total * (8 + c) + total + b * g * (8 + c)), float(total * (8 + c)), "bin_bwd_"),
        # Its order alone: idx, ranges and the packed rectangles read once, perm and offsets written once.
        ("bin_bwd_order", "transplat_tpu_torch/csrc/binning_bwd.cu",
         "transplat_tpu/ops/rasterizer/pallas_binning.py:457", 0.0,
         lambda: binning.bin_bwd_order(lists, b, g), lambda: binning.bin_bwd_order_plain(lists, b, g),
         lambda: torch.sort(pair_rows, stable=True),
         4 * (2 * total + 2 * cells + 3 * b * g + 1), 0.0, "bin_bwd_"),
    ]
    notes = {
        "bin_bwd_sorted": {"kernel_is": "bin_bwd_order's two kernels and the segment sums",
                           "library_is": "index_add_ under torch.use_deterministic_algorithms (repeatable_ops)"},
        "bin_bwd_order": {"kernel_is": "the areas' prefix and the places (no sort)",
                          "library_is": "torch.sort(view * G + idx, stable=True) on keys made beforehand"},
    }
    # K3 and K4: occupancy and the spread of their blocks' times (raster_report.py),
    # K3 as a request runs it (cells in their own order), K4 as a step does.
    lengths = (lists.ranges[:, 1] - lists.ranges[:, 0]).long()
    work = raster_report.needed_work(gfeat, colors, lists)
    visited = work.pop("visited")
    spread = {
        "composite": lambda bt: composite._composite_fwd_cuda(gfeat, colors, lists, bg, image_shape, block_times=bt),
        "composite_bwd": lambda bt: composite._composite_bwd_cuda(gfeat, colors, lists, bg_b, image, t_final, g_out,
                                                                  order=order, block_times=bt),
    }
    for name, src, replaces, e, fn, plain_fn, lib_fn, nbytes, flops, kernel in specs:
        b_ms, b_by = bound(nbytes, flops)
        rec = dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=launches.get(name, 0),
            max_abs_err=e, plain_ms=time_ms(plain_fn, iters=3, warmup=1), bound_ms=b_ms, bound_by=b_by,
            **timings(fn, kernel, lib_fn),
        )
        if name in spread:
            eval_ops, kept_ops = NEEDED_OPS[name]
            needed = work["unculled"] * eval_ops + work["kept"] * kept_ops(c)
            rec["needed_bound_ms"], rec["needed_bound_by"] = bound(nbytes, needed)
            rec["work"] = work
            att = raster_report.kernel_attributes(name, c, cells)
            rec.update({k: att[k] for k in ("regs", "smem_bytes", "local_bytes", "blocks_per_sm", "waves")})
            blocks = raster_report.block_spread(spread[name], cells, lengths, visited, gfeat.device)
            rec.update(block_us=blocks["block_us"], block_span_us=blocks["span_us"],
                       corr_block_time_visited=blocks["corr_time_visited_length"])
        rec.update(notes.get(name, {}))
        emit({"phase": "kernel", "scene": label, **sizes, **rec})
        recs.append(rec)
    return recs


def train_slice(dev, records: list[dict]) -> dict:
    """Three full-width re10k training steps through make_train_step; returns
    {"ms_per_step": median, "peak_mem_bytes": peak} of the timed steps."""
    from transplat_tpu_torch import kernels
    from transplat_tpu_torch.inference import re10k_decoder_cfg, re10k_encoder_cfg
    from transplat_tpu_torch.loss import LossCfg
    from transplat_tpu_torch.train_demo import build
    from transplat_tpu_torch.training.step import loss_and_grads

    gc.collect()
    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated()  # what earlier phases still hold; part of the peak below
    cfg = re10k_encoder_cfg()
    state, step, batch, gen = build(cfg, IMAGE, dev, SEED, num_target=NUM_TARGET)

    def fixed_batch_loss():
        """Loss and gradients on the fixed batch with dropout off (BatchNorm on batch statistics)."""
        metrics, grads = loss_and_grads(state, batch, LossCfg(), re10k_decoder_cfg(), IMAGE, deterministic=True)
        return float(metrics["loss"]), grads

    loss_before, grads = fixed_batch_loss()
    require(np.isfinite(loss_before), "train_slice: loss is not finite")
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    require(not bad, f"train_slice: non-finite gradients: {bad[:5]}")
    del grads
    state, _ = step(state, batch, gen)  # warm-up
    torch.cuda.synchronize()
    trainable = {k: p.detach().clone() for k, p in state.trainable().items()}
    frozen = {k: p.detach().clone() for k, p in state.encoder.da_model.named_parameters()}
    # The two snapshots stay alive through the timed steps and are part of the peak below.
    snapshot_bytes = sum(4 * p.numel() for p in (*trainable.values(), *frozen.values()))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times, metrics_all = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics_all.append({k: float(v) for k, v in metrics.items()})
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    for name in FORWARD_KERNELS + BACKWARD_KERNELS:
        require(launches.get(name, 0) > 0, f"kernel {name} was not launched by the training steps")
    for name in (*SORTED_MODES.values(), *SORTED_ORDERS.values()):
        require(launches.get(name, 0) == 0, f"train_slice: {name} launched with deterministic_kernels off")
    for m in metrics_all:
        require(all(np.isfinite(v) for v in m.values()), f"train_slice: non-finite metrics {m}")
        require(m["grad_norm"] > 0.0, "train_slice: grad_norm is 0")
    unmoved = [k for k, p in state.trainable().items() if torch.equal(p, trainable[k])]
    require(not unmoved, f"train_slice: {len(unmoved)} trainable parameters did not move, e.g. {unmoved[:5]}")
    moved = [k for k, p in state.encoder.da_model.named_parameters() if not torch.equal(p, frozen[k])]
    require(not moved, f"train_slice: frozen DAv2 parameters moved: {moved[:5]}")
    del trainable, frozen
    loss_after, _ = fixed_batch_loss()
    require(loss_after < loss_before, f"train_slice: loss on the fixed batch went from {loss_before} to {loss_after}")
    for rec in records:  # launches of each kernel by the three training steps, beside the serving count
        rec["launches_train"] = launches.get(rec["name"], 0)
        if rec["name"] in BACKWARD_KERNELS:
            rec["launches"] = rec["launches_train"]
    emit({"phase": "train_slice", "steps": TRAIN_STEPS, "ms_per_step": float(np.median(times)), "ms_all": times,
          "peak_mem_bytes": peak, "held_by_earlier_phases_bytes": held_before,
          "parameter_snapshots_bytes": snapshot_bytes, "launches": launches,
          "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
          "loss_fixed_batch_before": loss_before, "loss_fixed_batch_after": loss_after,
          "trainable_parameters": len(state.trainable()), "metrics": metrics_all, "dropout": True,
          "lpips": "random-init weights", "gaussians": 2 * IMAGE[0] * IMAGE[1]})
    return {"ms_per_step": float(np.median(times)), "peak_mem_bytes": peak}


def train_deterministic(dev, records: list[dict]) -> None:
    """trainer.deterministic_kernels at full width: from one state, two
    forward-backward passes give the same loss and gradients, and two
    training steps the same metrics, parameters, BatchNorm statistics and
    Adam moments, bit for bit. Launch counts are reset just before the first
    step and read just after: the sorted modes of K2 and K8 must have run and
    their atomic modes not. The warnings of
    torch.use_deterministic_algorithms (warn_only) during that step name the
    operations that have no deterministic version."""
    import copy
    import warnings

    from transplat_tpu_torch import kernels
    from transplat_tpu_torch.inference import re10k_decoder_cfg, re10k_encoder_cfg
    from transplat_tpu_torch.loss import LossCfg
    from transplat_tpu_torch.train_demo import build
    from transplat_tpu_torch.training.step import loss_and_grads

    gc.collect()
    torch.cuda.empty_cache()
    state, step, batch, gen = build(re10k_encoder_cfg(), IMAGE, dev, SEED, num_target=NUM_TARGET,
                                    deterministic_kernels=True)
    with warnings.catch_warnings(record=True) as caught:  # a warning may come once, at the first step
        warnings.simplefilter("always")
        state, _ = step(state, batch, gen.manual_seed(SEED))  # warm-up, and a state past step 0
    warned = {str(w.message).splitlines()[0] for w in caught}
    passes = []
    for _ in range(2):
        metrics, grads = loss_and_grads(copy.deepcopy(state), batch, LossCfg(), re10k_decoder_cfg(), IMAGE,
                                        gen.manual_seed(SEED + 1), deterministic_kernels=True)
        passes.append((float(metrics["loss"]), grads))
    require(passes[0][0] == passes[1][0], f"train_deterministic: losses {passes[0][0]} vs {passes[1][0]}")
    differ = [k for k, g in passes[0][1].items() if not torch.equal(g, passes[1][1][k])]
    require(not differ, f"train_deterministic: {len(differ)} gradients differ, e.g. {differ[:5]}")
    del passes
    runs = []
    for i in range(2):
        s = copy.deepcopy(state)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            s, metrics = step(s, batch, gen.manual_seed(SEED + 2))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        runs.append((s, {k: float(v) for k, v in metrics.items()}, dict(kernels.launches), ms,
                     sorted({str(w.message).splitlines()[0] for w in caught})))
    (s0, m0, launches, _, warned_step), (s1, m1, _, _, _) = runs
    warned = sorted(warned | set(warned_step))
    require(m0 == m1, f"train_deterministic: step metrics differ: {m0} vs {m1}")
    sd0, sd1 = s0.encoder.state_dict(), s1.encoder.state_dict()
    differ = [k for k in sd0 if not torch.equal(sd0[k], sd1[k])]
    differ += [k for k in s0.opt_state.mu if not (torch.equal(s0.opt_state.mu[k], s1.opt_state.mu[k])
                                                   and torch.equal(s0.opt_state.nu[k], s1.opt_state.nu[k]))]
    require(not differ, f"train_deterministic: {len(differ)} parameters, statistics or moments differ, e.g. {differ[:5]}")
    for atomic, sorted_mode in SORTED_MODES.items():
        require(launches.get(sorted_mode, 0) > 0 and launches.get(atomic, 0) == 0,
                f"train_deterministic: {sorted_mode} / {atomic} launched {launches.get(sorted_mode, 0)} / {launches.get(atomic, 0)}")
    for name in FORWARD_KERNELS + ("deform_scores_bwd_p1", "deform_scores_bwd_p4", "composite_bwd",
                                   *SORTED_ORDERS.values()):
        require(launches.get(name, 0) > 0, f"train_deterministic: kernel {name} was not launched")
    for rec in records:
        if rec["name"] in (*SORTED_MODES.values(), *SORTED_ORDERS.values()):
            rec["launches"] = rec["launches_train"] = launches.get(rec["name"], 0)
    emit({"phase": "train_deterministic", "steps": 2, "from_one_state": True, "bit_identical": True,
          "loss": m0["loss"], "ms_per_step": [r[3] for r in runs], "launches": launches,
          "warnings_use_deterministic_algorithms": warned, "dropout": True})


# precision_remat: the encoder's compute dtype and gradient checkpointing at full width.
PRECISION_SETTINGS = {
    "float32": {},
    "bfloat16": {"compute_dtype": "bfloat16"},
    "remat": {"remat_unet": True, "remat_matching": True},
    "bfloat16_remat": {"compute_dtype": "bfloat16", "remat_unet": True, "remat_matching": True},
}
# The bf16 step against the float32 step from one state (past Adam's first,
# sign-like update), dropout masks alike: the loss within PRECISION_LOSS_RTOL
# relative, the update's cosine at least PRECISION_MIN_COSINE. The tiny
# configuration on the CPU reads 3e-4 and 0.99 against JAX's bf16 step
# (tests/test_torch_training.py); at full width the random LPIPS and 131,072
# Gaussians average more values, so the same bounds leave room.
PRECISION_LOSS_RTOL = 1e-2
PRECISION_MIN_COSINE = 0.9


def _state_as(state, cfg, dev):
    """A copy of `state` whose encoder is built from `cfg`: the same
    parameters, BatchNorm statistics, Adam moments and step."""
    import copy

    from transplat_tpu_torch.model.encoder import EncoderTranSplat
    from transplat_tpu_torch.training.step import TrainState

    encoder = EncoderTranSplat(cfg, device=dev)
    encoder.load_state_dict(state.encoder.state_dict())
    return TrainState(step=state.step, encoder=encoder, lpips=state.lpips, opt_state=copy.deepcopy(state.opt_state))


def _flat_update(state, before: dict) -> torch.Tensor:
    return torch.cat([(p.detach() - before[k]).reshape(-1) for k, p in state.trainable().items()])


def precision_remat(dev, records: list[dict], encoder_cfg=None, image=IMAGE, steps: int = TRAIN_STEPS) -> None:
    """The re10k training step of train_slice with s2d_unet off in four
    settings (PRECISION_SETTINGS), each from one state (one step past
    initialisation) with one warm-up and `steps` timed steps: ms per step,
    peak bytes, every kernel counter's launches (K5 at P = 4 and K7 twice a
    step, four times under remat_matching, where the backward runs each fine
    layer again), and the dtypes of every tensor a kernel wrapper checked
    (float32 only: a bf16 tensor that reached a kernel would raise). The
    warm-up steps start alike (state, batch, dropout seed), so the bf16
    step's loss and update are held against the float32 step's. With
    trainer.deterministic_kernels the checkpointed forward and backward
    equal the plain one bit for bit (loss, every gradient, the dropout
    generator's state), in float32 and in bf16. One bf16 request against the
    float32 request of the same weights: ms and the Gaussians' gap."""
    import dataclasses

    from transplat_tpu_torch import kernels
    from transplat_tpu_torch.inference import re10k_decoder_cfg, re10k_encoder_cfg, render_novel_views
    from transplat_tpu_torch.loss import LossCfg
    from transplat_tpu_torch.train_demo import RE10K_LR, RE10K_MAX_STEPS, build
    from transplat_tpu_torch.training import make_lr_schedule, make_optimizer, make_train_step
    from transplat_tpu_torch.training.step import loss_and_grads

    gc.collect()
    torch.cuda.empty_cache()
    base = dataclasses.replace(encoder_cfg or re10k_encoder_cfg(), s2d_unet=False)
    state0, step0, batch, gen = build(base, image, dev, SEED, num_target=NUM_TARGET)
    state0, _ = step0(state0, batch, gen.manual_seed(SEED))  # past Adam's first update
    before = {k: p.detach().clone() for k, p in state0.trainable().items()}
    optimizer = make_optimizer(make_lr_schedule(RE10K_LR, RE10K_MAX_STEPS), grad_clip=0.5)
    checked = kernels.check_cuda_tensor
    seen_dtypes = set()

    def spy(name, t, dtype, ndim=None):
        seen_dtypes.add(str(t.dtype).replace("torch.", ""))
        return checked(name, t, dtype, ndim)

    settings, warm = {}, {}
    for name, fields in PRECISION_SETTINGS.items():
        cfg = dataclasses.replace(base, **fields)
        state = _state_as(state0, cfg, dev)
        step = make_train_step(cfg, LossCfg(), re10k_decoder_cfg(), optimizer, image)
        state, metrics = step(state, batch, gen.manual_seed(SEED + 1))  # warm-up, from state0 alike
        torch.cuda.synchronize()
        warm[name] = (float(metrics["loss"]), _flat_update(state, before))
        seen_dtypes.clear()
        kernels.check_cuda_tensor = spy
        try:
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            times = []
            for _ in range(steps):
                t0 = time.perf_counter()
                state, metrics = step(state, batch, gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            launches = dict(kernels.launches)
            peak = torch.cuda.max_memory_allocated()
        finally:
            kernels.check_cuda_tensor = checked
        require(np.isfinite(float(metrics["loss"])), f"precision_remat {name}: loss {float(metrics['loss'])}")
        require(seen_dtypes and "bfloat16" not in seen_dtypes, f"precision_remat {name}: kernel inputs {seen_dtypes}")
        fine = 4 if fields.get("remat_matching") else 2
        for counter in ("deform_scores_p4", "deform_vectors"):
            require(launches.get(counter, 0) == fine * steps,
                    f"precision_remat {name}: {counter} launched {launches.get(counter, 0)} times in {steps} steps")
        for counter in FORWARD_KERNELS + BACKWARD_KERNELS:
            require(launches.get(counter, 0) > 0, f"precision_remat {name}: kernel {counter} was not launched")
        settings[name] = {"fields": fields, "ms_per_step": float(np.median(times)), "ms_all": times,
                          "peak_mem_bytes": peak, "launches_per_step": {k: v / steps for k, v in launches.items()},
                          "kernel_input_dtypes": sorted(seen_dtypes), "loss_last": float(metrics["loss"])}
        del state, step
        gc.collect()
        torch.cuda.empty_cache()

    # bf16 against float32: the warm-up steps from one state.
    comparisons = {}
    for name in ("bfloat16", "bfloat16_remat"):
        loss_rel = abs(warm[name][0] / warm["float32"][0] - 1.0)
        cosine = float(torch.nn.functional.cosine_similarity(warm[name][1], warm["float32"][1], dim=0))
        comparisons[name] = {"loss_rel": loss_rel, "update_cosine": cosine}
        require(loss_rel <= PRECISION_LOSS_RTOL and cosine >= PRECISION_MIN_COSINE,
                f"precision_remat {name} vs float32: loss rel {loss_rel}, update cosine {cosine}")
    del warm

    # Checkpointed against plain, repeatable kernels: bit for bit.
    bits = {}
    for dtype in ("float32", "bfloat16"):
        runs = []
        for fields in ({}, {"remat_unet": True, "remat_matching": True}):
            cfg = dataclasses.replace(base, compute_dtype=dtype, **fields)
            g = torch.Generator(device=dev).manual_seed(SEED + 2)
            metrics, grads = loss_and_grads(_state_as(state0, cfg, dev), batch, LossCfg(), re10k_decoder_cfg(), image,
                                            g, deterministic_kernels=True)
            runs.append((float(metrics["loss"]), grads, g.get_state()))
        (l0, g0, r0), (l1, g1, r1) = runs
        differ = [k for k in g0 if not torch.equal(g0[k], g1[k])]
        gap = max((float((g0[k] - g1[k]).abs().max()) for k in differ), default=0.0)
        bits[dtype] = {"loss_equal": l0 == l1, "gradients_differ": len(differ), "max_abs_gap": gap,
                       "generator_equal": bool(torch.equal(r0, r1)), "leaves": len(g0)}
        require(l0 == l1 and not differ and torch.equal(r0, r1),
                f"precision_remat: checkpointed step ({dtype}) differs from the plain one: {bits[dtype]}, {differ[:5]}")
        del runs, g0, g1

    # One full-width request at bf16 against float32, the same weights.
    ctx, tgt = batch["context"], batch["target"]
    encoders = {dtype: _state_as(state0, dataclasses.replace(base, compute_dtype=dtype), dev).encoder
                for dtype in ("float32", "bfloat16")}
    for encoder in encoders.values():
        render_novel_views(encoder, ctx, tgt, image, device=dev)  # warm-up
    request_ms = {dtype: [] for dtype in encoders}
    for _ in range(3):
        for dtype, encoder in encoders.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render_novel_views(encoder, ctx, tgt, image, device=dev)
            torch.cuda.synchronize()
            request_ms[dtype].append((time.perf_counter() - t0) * 1e3)
            require(bool(torch.isfinite(out).all()), f"precision_remat: {dtype} request not finite")
    with torch.no_grad():
        gs = {dtype: enc(*(ctx[k] for k in ("image", "intrinsics", "extrinsics", "near", "far")))
              for dtype, enc in encoders.items()}
    gap = {field: {"max_abs": float((getattr(gs["bfloat16"], field) - getattr(gs["float32"], field)).abs().max()),
                   "rms": float((getattr(gs["bfloat16"], field) - getattr(gs["float32"], field)).pow(2).mean().sqrt()),
                   "rms_float32": float(getattr(gs["float32"], field).pow(2).mean().sqrt())}
           for field in ("means", "opacities", "harmonics")}
    emit({"phase": "precision_remat", "steps": steps, "settings": settings, "bf16_vs_float32_step": comparisons,
          "loss_rtol": PRECISION_LOSS_RTOL, "min_update_cosine": PRECISION_MIN_COSINE,
          "checkpointed_vs_plain_deterministic": bits,
          "request_ms": {k: float(np.median(v)) for k, v in request_ms.items()}, "request_ms_all": request_ms,
          "gaussians_bf16_vs_float32": gap, "s2d_unet": False, "dropout": True})
    for rec in records:
        rec["launches_precision_remat"] = {name: st["launches_per_step"].get(rec["name"], 0.0)
                                           for name, st in settings.items()}


def fit_slice(dev, records: list[dict], smi: str, media_kernels: dict) -> None:
    """Path 3 at full width on the 256x256 golden scene: evaluate, fit
    FIT_STEPS steps through the Trainer (one sanity validation, one
    validation and one checkpoint in the middle, one checkpoint at the end;
    every validation writes its grid, projections and wobble video),
    validate with and without media (`validation_media`), resume a fresh
    Trainer from the middle checkpoint, evaluate again."""
    import itertools
    import os
    import shutil
    import tempfile

    from transplat_tpu_torch import kernels
    from transplat_tpu_torch.config import load_config
    from transplat_tpu_torch.dataset import golden_scene_batch
    from transplat_tpu_torch.evaluation import Evaluator
    from transplat_tpu_torch.loss import LPIPS
    from transplat_tpu_torch.training import CheckpointManager, Trainer, create_train_state

    gc.collect()
    torch.cuda.empty_cache()
    half = FIT_STEPS // 2
    batch = golden_scene_batch(num_context=2, num_target=NUM_TARGET, image_shape=IMAGE)
    lpips = LPIPS(device=dev, seed=SEED)  # random-init weights, as in train_slice
    with tempfile.TemporaryDirectory() as tmp:
        def config(run: str):
            return load_config(
                "re10k",
                optimizer=dict(lr=4e-4, cosine_lr=True, warm_up_steps=1),  # the overfit schedule
                trainer=dict(max_steps=FIT_STEPS, num_sanity_val_steps=1, val_check_interval=half, seed=SEED),
                checkpointing=dict(save_dir=f"{tmp}/{run}/checkpoints", every_n_train_steps=half),
                test=dict(output_path=f"{tmp}/{run}/test", eval_time_skip_steps=0),
            )

        cfg = config("run")
        logs: list[str] = []
        trainer = Trainer(cfg, log_fn=logs.append, device=dev, lpips=lpips, log_every=1)
        # The state fit() will start from (same seed, same generator): scored before training.
        initial = create_train_state(cfg.encoder, trainer.optimizer, lpips, device=dev, seed=cfg.trainer.seed)
        before, _ = Evaluator(cfg, initial.encoder, lpips, device=dev).evaluate_batch(batch)
        del initial
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        state = trainer.fit(itertools.repeat(batch), max_steps=FIT_STEPS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        for name in FORWARD_KERNELS + BACKWARD_KERNELS:
            require(launches.get(name, 0) > 0, f"kernel {name} was not launched by fit_slice")
        require(state.step == FIT_STEPS, f"fit_slice: stopped at step {state.step}")
        ckpt_dir = cfg.checkpointing.save_dir
        names = sorted(os.listdir(ckpt_dir))
        require(names == ["config.json", f"step_{half:08d}.pt", f"step_{FIT_STEPS:08d}.pt"], f"fit_slice: checkpoints {names}")
        with open(f"{tmp}/run/metrics.jsonl") as f:
            lines = [json.loads(line) for line in f]
        steps = {r["step"]: r for r in lines if "loss" in r}
        vals = [r for r in lines if "val_psnr" in r]
        require(sorted(steps) == list(range(1, FIT_STEPS + 1)), "fit_slice: a step's metrics record is missing")
        require(all(np.isfinite(v) for r in steps.values() for v in r.values()), "fit_slice: non-finite step metrics")
        require([r["step"] for r in vals] == [half, FIT_STEPS] and sum("sanity validation" in m for m in logs) == 1,
                f"fit_slice: validations {vals}, logs {logs[:2]}")
        media = sorted(os.listdir(f"{tmp}/run/local"))
        require(media == sorted(f"{kind}_{s:08d}.{ext}" for s in (0, half, FIT_STEPS)
                                for kind, ext in (("projections", "png"), ("validation", "png"), ("wobble", "mp4"))),
                f"fit_slice: validation media {media}")
        validation_media(dev, trainer, state, batch, f"{tmp}/media", smi, media_kernels)
        evaluator = Evaluator(cfg, state.encoder, lpips, device=dev)
        after, color = evaluator.evaluate_batch(batch)
        evaluator.scores[batch["scene"][0]] = after
        evaluator.finalize(cfg.test.output_path)
        require(sorted(os.listdir(cfg.test.output_path)) == ["benchmark.json", "scores_all_avg.json", "scores_per_scene.json"],
                "fit_slice: the evaluator's files")
        require(color.shape == (1, NUM_TARGET, *IMAGE, 3) and bool(np.isfinite(color).all()), "fit_slice: rendered colours")
        for scores in (before, after):
            require(all(np.isfinite(scores[k]) for k in ("psnr", "ssim", "lpips")), f"fit_slice: scores {scores}")
            require(scores["render_overflow"] == 0, "fit_slice: render_overflow is not 0")
        gain = after["psnr"] - before["psnr"]
        require(gain >= FIT_MIN_PSNR_GAIN_DB, f"fit_slice: PSNR {before['psnr']:.2f} -> {after['psnr']:.2f} dB, gain under {FIT_MIN_PSNR_GAIN_DB}")

        # A fresh Trainer on the middle checkpoint alone: its first step repeats step half + 1.
        resumed_cfg = config("resumed")
        os.makedirs(resumed_cfg.checkpointing.save_dir)
        shutil.copy(f"{ckpt_dir}/step_{half:08d}.pt", resumed_cfg.checkpointing.save_dir)
        size = os.path.getsize(f"{ckpt_dir}/step_{half:08d}.pt")
        del state, evaluator
        resumed_logs: list[str] = []
        resumed = Trainer(resumed_cfg, log_fn=resumed_logs.append, device=dev, lpips=lpips, log_every=1)
        state = resumed.fit(itertools.repeat(batch), max_steps=half + 1)
        require(f"resumed from step {half}" in resumed_logs and state.step == half + 1, f"fit_slice: resume {resumed_logs[:3]}")
        with open(f"{tmp}/resumed/metrics.jsonl") as f:
            again = [r for r in map(json.loads, f) if "loss" in r][0]
        first = steps[half + 1]
        # Same parameters, BatchNorm statistics, Adam state, learning rate and
        # dropout masks; the forward's kernels are deterministic: 1e-4 relative.
        rel = abs(again["loss"] - first["loss"]) / abs(first["loss"])
        require(again["step"] == half + 1 and rel <= 1e-4 and again["lr"] == first["lr"],
                f"fit_slice: resumed step {again} vs first run {first}")

        # Save and restore, timed on their own.
        mgr = CheckpointManager(f"{tmp}/timed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(state.step, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        require(mgr.restore(state) is state, "fit_slice: restore")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    for rec in records:
        rec["launches_fit"] = launches.get(rec["name"], 0)
    step_ms = [1e3 * steps[i]["s_per_it"] for i in sorted(steps)]
    emit({"phase": "fit_slice", "steps": FIT_STEPS, "fit_s": fit_s, "ms_per_step_median": float(np.median(step_ms)),
          "peak_mem_bytes": peak, "scores_before": before, "scores_after": after, "psnr_gain_db": gain,
          "required_gain_db": FIT_MIN_PSNR_GAIN_DB, "val_psnr": [r["val_psnr"] for r in vals],
          "train_psnr_first_last": [steps[1]["psnr"], steps[FIT_STEPS]["psnr"]],
          "loss_first_last": [steps[1]["loss"], steps[FIT_STEPS]["loss"]],
          "resumed_step": half + 1, "resumed_loss": again["loss"], "first_run_loss": first["loss"], "resumed_loss_rel_err": rel,
          "resume_tolerance": 1e-4, "checkpoint_bytes": size, "save_s": save_s, "restore_s": restore_s,
          "launches": launches, "launches_per_step": {k: v / FIT_STEPS for k, v in launches.items()},
          "lpips": "random-init weights", "scene": "golden_planes", "gaussians": 2 * IMAGE[0] * IMAGE[1],
          "validation_media_files": len(media)})


# A validation with media renders the first example's Gaussians in 3
# orthographic views at 128^2 and a wobble of this many frames.
WOBBLE_FRAMES = 14
ORTHO_SHAPE = (128, 128)
ORTHO_CPU_GAUSSIANS = 8192


def media_renders(g0, ctx: dict, dev) -> dict:
    """The two renders a validation with media adds, for the first example's
    Gaussians `g0` and its context `ctx`, as Trainer._save_validation_media
    makes them: the orthographic views (3 at ORTHO_SHAPE, unscaled) and the
    wobble's decode (WOBBLE_FRAMES at IMAGE); projected and depth-sorted."""
    from transplat_tpu_torch.model.types import Gaussians
    from transplat_tpu_torch.ops.rasterizer import api, binning
    from transplat_tpu_torch.visualization.validation_3d import axis_looks, orthographic_cameras, validation_wobble

    looks, extent = axis_looks(g0.means[0].cpu().numpy())
    looks_t = torch.as_tensor(np.stack([e for _, e in looks]), dtype=torch.float32, device=dev)
    g3 = Gaussians(*(x.expand(3, *x.shape[1:]).contiguous() for x in g0))
    box = (extent, extent, 0.0, 2.0 * extent)
    cams = orthographic_cameras(looks_t, *box)
    ortho = binning.sort_by_depth(api.project_views(cams[0], cams[1], cams[2], *g3, ORTHO_SHAPE, scale_invariant=False))
    wobble = torch.as_tensor(validation_wobble(ctx["extrinsics"][0].cpu().numpy(), WOBBLE_FRAMES),
                             dtype=torch.float32, device=dev)
    first = lambda x: x[0, :1].expand(WOBBLE_FRAMES, *x.shape[2:]).contiguous()  # noqa: E731
    wob = binning.sort_by_depth(api.project_views(wobble, first(ctx["intrinsics"]), first(ctx["near"]),
                                                  *(x.expand(WOBBLE_FRAMES, *x.shape[1:]).contiguous() for x in g0), IMAGE))
    return dict(g3=g3, looks=looks_t, box=box, extent=extent, distance=float(cams[2][0]),
                ortho=(*ortho, ORTHO_SHAPE, 3), wobble=(*wob, IMAGE, WOBBLE_FRAMES))


def validation_media_kernels(encoder, dev, smi: str) -> dict:
    """K1 and K3 at the shapes a validation with media adds (the
    orthographic views, the wobble's decode), on the Gaussians `encoder`
    makes of the golden scene: tile pairs and device times (`timings`).
    Taken early in the script, as decode_30_views is: late in a long process
    the profiler has returned short traces (PERF.md §7)."""
    from transplat_tpu_torch.dataset import golden_scene_batch
    from transplat_tpu_torch.dataset.loader import CONTEXT_KEYS, batch_to_device
    from transplat_tpu_torch.model.types import Gaussians
    from transplat_tpu_torch.ops.rasterizer import binning, composite

    batch = golden_scene_batch(num_context=2, num_target=NUM_TARGET, image_shape=IMAGE)
    ctx = batch_to_device(batch, dev)["context"]
    rec = {"phase": "validation_media_kernels", "card": smi, "gaussians": "the serving encoder's, golden scene"}
    with torch.no_grad():
        m = media_renders(Gaussians(*(x[:1] for x in encoder(*(ctx[k] for k in CONTEXT_KEYS)))), ctx, dev)
        for name in ("ortho", "wobble"):
            gfeat, colors, shape, views = m[name]
            lists = binning.bin_gaussians(gfeat, shape)
            bg = torch.zeros((views, 3), device=dev)
            rec[name] = {"views": views, "h": shape[0], "w": shape[1], "pairs": int(lists.idx.numel()),
                         "k1_bin_gaussians": timings(lambda: binning.bin_gaussians(gfeat, shape), "bin_"),
                         "k3_composite": timings(lambda: composite._composite_fwd_cuda(gfeat, colors, lists, bg, shape),
                                                 "composite_kernel")}
    emit(rec)
    return rec


def validation_media(dev, trainer, state, batch: dict, out_dir: str, smi: str, kernel_times: dict) -> dict:
    """Trainer.validate with media at full width (path 3's trained state, the
    golden scene, 131,072 Gaussians): wall ms of a validation with and
    without media (median of 3, in turns, after a warm-up); launch counts
    reset just before one validation with media and read just after (K1 and
    K3 three times: the validation decode, the orthographic render, the
    wobble decode; K5 at P = 1 and 4 and K7 in the encoder); its three files,
    the video read back; peak bytes. Then the orthographic render's own
    inputs: K1 against its plain versions and K3 against
    composite_tiles_plain on them, the render on the card against the port
    on the CPU on the same ORTHO_CPU_GAUSSIANS of them, and both renders'
    tile pairs, beside the K1 / K3 device times of `kernel_times`
    (validation_media_kernels)."""
    import os

    from transplat_tpu_torch import kernels
    from transplat_tpu_torch.dataset.loader import CONTEXT_KEYS, batch_to_device
    from transplat_tpu_torch.model.types import Gaussians
    from transplat_tpu_torch.ops.rasterizer import binning, composite
    from transplat_tpu_torch.utils.image_io import load_video
    from transplat_tpu_torch.visualization.validation_3d import render_orthographic

    def validate(media: bool, where: str) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.validate(state, batch, out_dir=where, save_media=media)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    validate(True, f"{out_dir}/warm")
    with_ms, without_ms = [], []
    for _ in range(3):
        with_ms.append(validate(True, f"{out_dir}/timed"))
        without_ms.append(validate(False, f"{out_dir}/timed_grid"))
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    validate(True, f"{out_dir}/media")
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() - held
    require(all(launches.get(k, 0) == 3 for k in ("bin_count", "bin_scan", "bin_place", "composite")),
            f"validation_media: K1 / K3 launches {launches} (3 each expected)")
    require(all(launches.get(k, 0) > 0 for k in ("deform_scores_p1", "deform_scores_p4", "deform_vectors")),
            f"validation_media: encoder kernels {launches}")
    step = f"{trainer.global_step:08d}"
    names = sorted(os.listdir(f"{out_dir}/media"))
    require(names == [f"projections_{step}.png", f"validation_{step}.png", f"wobble_{step}.mp4"], f"validation_media: files {names}")
    require(sorted(os.listdir(f"{out_dir}/timed_grid")) == [f"validation_{step}.png"], "validation_media: save_media=False")
    video = load_video(f"{out_dir}/media/wobble_{step}.mp4")
    require(video.shape == (WOBBLE_FRAMES, *IMAGE, 3), f"validation_media: video {video.shape}")

    ctx = batch_to_device(batch, dev)["context"]
    with torch.no_grad():
        g0 = Gaussians(*(x[:1] for x in state.encoder(*(ctx[k] for k in CONTEXT_KEYS))))
        m = media_renders(g0, ctx, dev)
        ortho = render_orthographic(m["g3"], m["looks"], *m["box"], image_shape=ORTHO_SHAPE)
        gfeat, colors, _, _ = m["ortho"]
        k1 = check_binning(gfeat, ORTHO_SHAPE, 16, "ortho_render")
        bg = torch.zeros((3, 3), device=dev)
        img = composite.composite_tiles(gfeat, colors, k1["lists"], bg, ORTHO_SHAPE)
        img_p, _, evaluations = composite.composite_tiles_plain(gfeat, colors, k1["lists"], bg, ORTHO_SHAPE)
        err, share = require_composite(img, img_p, "ortho render: composite")
        require(max_err(img, ortho) <= 1e-5, f"ortho render: the kernels' image vs render_orthographic {max_err(img, ortho)}")
        require(float(ortho.max()) > 0.05 and bool(torch.isfinite(ortho).all()), "ortho render: an empty or non-finite view")
        # Card against CPU on a seeded subset: the CPU's plain compositor takes
        # ~G^1.5 time here (every Gaussian lands in a 128^2 view).
        keep = torch.randperm(m["g3"].means.shape[1], generator=torch.Generator().manual_seed(SEED))[:ORTHO_CPU_GAUSSIANS]
        sub = Gaussians(*(x[:, keep.to(dev)].contiguous() for x in m["g3"]))
        sub_card = render_orthographic(sub, m["looks"], *m["box"], image_shape=ORTHO_SHAPE)
        t0 = time.perf_counter()
        sub_cpu = render_orthographic(Gaussians(*(x.cpu() for x in sub)), m["looks"].cpu(), *m["box"], image_shape=ORTHO_SHAPE)
        cpu_s = time.perf_counter() - t0
        diff = (sub_card.cpu() - sub_cpu).abs()
        cpu_err, cpu_share = float(diff.max()), float((diff > 1e-4).float().mean())
        # The same Gaussians on the card and on the CPU: projection rounding can
        # flip an integer radius or the 1/255 alpha floor (tiny_slice_vs_cpu).
        require(cpu_share < 0.02 and cpu_err < 0.05, f"ortho render card vs CPU: max {cpu_err}, share beyond 1e-4 {cpu_share}")
        wobble_pairs = int(binning.bin_gaussians(m["wobble"][0], IMAGE).idx.numel())
    rec = {
        "phase": "validation_media", "card": smi, "step": trainer.global_step, "gaussians": int(g0.means.shape[1]),
        "validation_with_media_ms": float(np.median(with_ms)), "validation_without_media_ms": float(np.median(without_ms)),
        "validation_with_media_ms_all": with_ms, "validation_without_media_ms_all": without_ms,
        "launches": launches, "peak_bytes_above_held": peak, "files": names, "video_frames": int(video.shape[0]),
        "ortho": {"views": 3, "h": ORTHO_SHAPE[0], "w": ORTHO_SHAPE[1], "extent": m["extent"], "camera_distance": m["distance"],
                  "pairs": k1["total"], "evaluations": evaluations,
                  "composite_vs_plain_max_abs_err": err, "composite_vs_plain_share_beyond_1e-5": share,
                  "card_vs_cpu_max_abs_err": cpu_err, "card_vs_cpu_share_beyond_1e-4": cpu_share,
                  "card_vs_cpu_gaussians": ORTHO_CPU_GAUSSIANS,
                  "card_vs_cpu_tolerance": "98% within 1e-4, all within 0.05", "cpu_render_s": cpu_s},
        "wobble": {"views": WOBBLE_FRAMES, "h": IMAGE[0], "w": IMAGE[1], "pairs": wobble_pairs},
        "kernel_times": {k: kernel_times[k] for k in ("ortho", "wobble")},
        "kernel_times_on": "validation_media_kernels: the serving encoder's Gaussians of the golden scene",
    }
    emit(rec)
    return rec


def convert_weights_phase() -> None:
    """The checkpoint converter's command line on this machine (no JAX
    here): `python -m transplat_tpu_torch.convert_weights --kind lpips` on a
    torch.save'd seeded LPIPS state dict, and its --dry-run. The .npy,
    loaded by load_lpips_weights, must fill an LPIPS with the same bits as
    the state dict loaded directly; the dry run lists every key with its
    shape."""
    import os
    import tempfile

    from transplat_tpu_torch.loss.vgg import LPIPS, load_lpips_weights

    state = seeded_lpips_state()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({k: torch.from_numpy(v) for k, v in state.items()}, f"{tmp}/lpips.pth")

        # Both command lines at once: each spends most of its time importing torch.
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-m", "transplat_tpu_torch.convert_weights", f"{tmp}/lpips.pth",
                                   "--kind", "lpips", "--out", f"{tmp}/lpips.npy", *extra],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root)
                 for extra in ([], ["--dry-run"])]
        try:
            (out, err), (dry, dry_err) = (p.communicate(timeout=300) for p in procs)
        finally:
            for p in procs:
                p.kill()
        command_s = time.perf_counter() - t0
        require(procs[0].returncode == 0 and procs[1].returncode == 0, f"convert_weights: {err[-1000:]} {dry_err[-1000:]}")
        require(out.strip() == f"wrote {tmp}/lpips.npy", f"convert_weights: {out!r}")
        require(dry.splitlines() == [f"{k} {state[k].shape}" for k in sorted(state)], f"convert_weights --dry-run: {dry[:500]!r}")
        tree = np.load(f"{tmp}/lpips.npy", allow_pickle=True).item()
    converted = load_lpips_weights(LPIPS(device="cuda", seed=1), tree).state_dict()
    direct = load_lpips_weights(LPIPS(device="cuda", seed=2), state).state_dict()
    require(list(converted) == list(direct) and all(torch.equal(converted[k], direct[k]) for k in direct),
            "convert_weights: the converted LPIPS differs from the state dict loaded directly")
    emit({"phase": "convert_weights", "kind": "lpips", "keys": len(tree), "dry_run_lines": len(dry.splitlines()),
          "lpips_tensors_bit_equal": len(direct), "both_commands_s": command_s})


def fit_resume_deterministic(dev, records: list[dict]) -> None:
    """Path 3 with trainer.deterministic_kernels on, at full width on the
    golden scene: Trainer.fit for FIT_DET_STEPS steps with a checkpoint in the
    middle, then a fresh Trainer resumed from it. The resumed steps' metrics
    and the final parameters, BatchNorm statistics and Adam moments must
    equal the first run's exactly (tolerance 0)."""
    import itertools
    import os
    import shutil
    import tempfile

    from transplat_tpu_torch import kernels
    from transplat_tpu_torch.config import load_config
    from transplat_tpu_torch.dataset import golden_scene_batch
    from transplat_tpu_torch.loss import LPIPS
    from transplat_tpu_torch.training import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    half = FIT_DET_STEPS // 2
    batch = golden_scene_batch(num_context=2, num_target=NUM_TARGET, image_shape=IMAGE)
    lpips = LPIPS(device=dev, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        def config(run: str):
            return load_config(
                "re10k",
                optimizer=dict(lr=4e-4, cosine_lr=True, warm_up_steps=1),
                trainer=dict(max_steps=FIT_DET_STEPS, num_sanity_val_steps=0, val_check_interval=FIT_DET_STEPS,
                             seed=SEED, deterministic_kernels=True),
                checkpointing=dict(save_dir=f"{tmp}/{run}/checkpoints", every_n_train_steps=half),
            )

        kernels.reset_launches()
        first = Trainer(config("run"), log_fn=lambda m: None, device=dev, lpips=lpips, log_every=1)
        state = first.fit(itertools.repeat(batch), max_steps=FIT_DET_STEPS)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        for atomic, sorted_mode in SORTED_MODES.items():
            require(launches.get(sorted_mode, 0) > 0 and launches.get(SORTED_ORDERS[sorted_mode], 0) > 0
                    and launches.get(atomic, 0) == 0, f"fit_resume_deterministic: {sorted_mode} / {atomic} launched")
        want = {k: v.clone() for k, v in state.encoder.state_dict().items()}
        moments = {k: (state.opt_state.mu[k].clone(), state.opt_state.nu[k].clone()) for k in state.opt_state.mu}
        del state
        resumed_cfg = config("resumed")
        os.makedirs(resumed_cfg.checkpointing.save_dir)
        shutil.copy(f"{tmp}/run/checkpoints/step_{half:08d}.pt", resumed_cfg.checkpointing.save_dir)
        logs: list[str] = []
        resumed = Trainer(resumed_cfg, log_fn=logs.append, device=dev, lpips=lpips, log_every=1)
        state = resumed.fit(itertools.repeat(batch), max_steps=FIT_DET_STEPS)
        require(f"resumed from step {half}" in logs and state.step == FIT_DET_STEPS, f"fit_resume_deterministic: {logs[:3]}")
        records_of = {}
        for run in ("run", "resumed"):
            with open(f"{tmp}/{run}/metrics.jsonl") as f:
                lines = [json.loads(line) for line in f]
            records_of[run] = {r["step"]: {k: v for k, v in r.items() if k != "s_per_it"} for r in lines if "loss" in r}
        resumed_steps = list(range(half + 1, FIT_DET_STEPS + 1))
        require(sorted(records_of["resumed"]) == resumed_steps, f"fit_resume_deterministic: steps {sorted(records_of['resumed'])}")
        for i in resumed_steps:
            require(records_of["resumed"][i] == records_of["run"][i],
                    f"fit_resume_deterministic: step {i}: {records_of['resumed'][i]} vs {records_of['run'][i]}")
        have = state.encoder.state_dict()
        differ = [k for k in want if not torch.equal(want[k], have[k])]
        differ += [k for k, (mu, nu) in moments.items()
                   if not (torch.equal(mu, state.opt_state.mu[k]) and torch.equal(nu, state.opt_state.nu[k]))]
        require(not differ, f"fit_resume_deterministic: {len(differ)} tensors differ after the resume, e.g. {differ[:5]}")
    for rec in records:
        rec["launches_fit_deterministic"] = launches.get(rec["name"], 0)
    emit({"phase": "fit_resume_deterministic", "steps": FIT_DET_STEPS, "resumed_from": half,
          "resumed_losses": [records_of["resumed"][i]["loss"] for i in resumed_steps],
          "first_run_losses": [records_of["run"][i]["loss"] for i in resumed_steps], "resume_tolerance": 0.0,
          "parameters_bit_identical": True, "launches": launches})


# Budgets (seconds) of the data-and-CLI phase's parts: a part that runs past
# its budget fails instead of waiting (a loader that never yields, a stuck worker).
DATA_BUDGET_S = {"native": 120, "chunks": 180, "generate_index": 120, "train": 420, "test": 180, "bench": 300,
                 "loader": 240, "eval_artifacts": 300}
# nvJPEG's chroma upsampling is not libjpeg's: a decode is held against the
# source pixels of the images its route encoded at quality 95, 4:2:0 (mean
# absolute error, of 1). Measured on an H100 machine (nvJPEG, 12.8 toolkit):
# 2.48-2.58 / 255 on chunks.panorama_frames; a decoder that shifts or
# swaps channels reads tens of levels.
JPEG_MAE_TOL = 3.0 / 255.0
TRAIN_SCENES, TRAIN_FRAMES, TEST_SCENES, TEST_FRAMES = 2, 30, 2, 60
CLI_TRAIN_STEPS = 4
LOADER_BATCHES = 12


class _Budget:
    """`with _Budget(part, times):` raises TimeoutError once the part has run
    DATA_BUDGET_S[part] seconds (SIGALRM), and records its seconds in `times`."""

    def __init__(self, part: str, times: dict):
        self.part, self.times = part, times

    def _expired(self, signum, frame):
        raise TimeoutError(f"data phase: part {self.part!r} ran past its {DATA_BUDGET_S[self.part]} s budget")

    def __enter__(self):
        import signal

        self.previous = signal.signal(signal.SIGALRM, self._expired)
        signal.alarm(DATA_BUDGET_S[self.part])
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import signal

        signal.alarm(0)
        signal.signal(signal.SIGALRM, self.previous)
        self.times[self.part] = time.perf_counter() - self.t0
        return False


def _main_quiet(argv: list[str]) -> tuple[int, str]:
    """transplat_tpu_torch.main in this process; (exit code, what it printed)."""
    import contextlib
    import io

    from transplat_tpu_torch.main import main as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    return rc, out.getvalue()


# The staged encoder against the fused one on the card: the largest
# |staged - fused| / (1 + |fused|) over the Gaussians' tensors. Both run the
# same operations in the same order on one stream, so they agree bit for bit
# where every kernel repeats its bits from call to call.
STAGED_TOL = 1e-6
# export_ply's rows of the Gaussians `main test` wrote against the same
# transform of the encoder's output in this process: |a - b| / (1 + |b|).
PLY_TOL = 1e-5
# compute_psnr of an image against itself: -10 log10(0 + 1e-12).
PSNR_SATURATION_DB = 120.0
VGG_PLAN = ((3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256), (256, 512), (512, 512),
            (512, 512), (512, 512), (512, 512), (512, 512))
VGG_FEATURE_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def seeded_lpips_state(naming: str = "torchvision", prefix: str = "", seed: int = 0) -> dict:
    """A seeded lpips(net='vgg') state dict, as numpy arrays, in torchvision's
    naming (`net.features.N`) or the lpips package's (`net.sliceK.N`), with
    the heads `lin{i}.model.1.weight`: He-scaled convs, small biases, heads
    in [0, 1)."""
    rng = np.random.RandomState(seed)
    state = {}
    for (cin, cout), idx in zip(VGG_PLAN, VGG_FEATURE_INDEX):
        if naming == "torchvision":
            name = f"{prefix}net.features.{idx}"
        else:
            name = f"{prefix}net.slice{1 + sum(idx > b for b in (3, 8, 15, 22))}.{idx}"
        state[f"{name}.weight"] = (rng.randn(cout, cin, 3, 3) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        state[f"{name}.bias"] = (0.01 * rng.randn(cout)).astype(np.float32)
    for i, ch in enumerate((64, 128, 256, 512, 512)):
        state[f"{prefix}lin{i}.model.1.weight"] = rng.rand(1, ch, 1, 1).astype(np.float32)
    return state


def _flat_tree(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def decode_30_views(encoder, batch: dict, dev, smi: str) -> dict:
    """K1 and K3 as a video's decode runs them: the Gaussians of `batch`'s
    context views rendered into the 30 wobble cameras of
    Evaluator.render_video in one call. Launches of one decode, tile pairs,
    peak bytes, ms between CUDA events, and each kernel's device times
    (`timings`: warm, cold, wrapper) beside the 4-view request's."""
    from transplat_tpu_torch import kernels
    from transplat_tpu_torch.dataset.loader import CONTEXT_KEYS, batch_to_device
    from transplat_tpu_torch.evaluation.evaluator import video_cameras
    from transplat_tpu_torch.model.decoder import decode_splatting
    from transplat_tpu_torch.ops.rasterizer import api, binning, composite

    ctx = batch_to_device(batch, dev)["context"]
    extr, intr = (torch.from_numpy(x)[None].to(dev) for x in video_cameras(batch)["wobble"])
    near = torch.full((1, 30), float(batch["context"]["near"][0, 0]), device=dev)
    far = torch.full((1, 30), float(batch["context"]["far"][0, 0]), device=dev)
    with torch.no_grad():
        gaussians = encoder(*(ctx[k] for k in CONTEXT_KEYS))

        def decode():
            return decode_splatting(gaussians, extr, intr, near, far, IMAGE)

        decode()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        decode()
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated() - held
        proj = api.project_views(extr[0], intr[0], near[0], *(x.expand(30, *x.shape[1:]).contiguous() for x in gaussians),
                                 IMAGE)
        gfeat, colors = binning.sort_by_depth(proj)
        lists = binning.bin_gaussians(gfeat, IMAGE)
        bg = torch.zeros(30, 3, device=dev)
        rec = {"phase": "decode_30_views", "card": smi, "views": 30, "gaussians": int(gaussians.means.shape[1]),
               "pairs": int(lists.idx.numel()), "launches": launches, "peak_bytes_above_held": peak,
               "decode_ms_events": time_ms(decode, iters=5, warmup=1),
               "k1_bin_gaussians": timings(lambda: binning.bin_gaussians(gfeat, IMAGE), "bin_"),
               "k3_composite": timings(lambda: composite._composite_fwd_cuda(gfeat, colors, lists, bg, IMAGE),
                                       "composite_kernel")}
    require(all(launches.get(k, 0) == 1 for k in ("bin_count", "bin_scan", "bin_place", "composite")),
            f"decode_30_views: launches {launches}")
    emit(rec)
    return rec


def eval_artifacts_phase(dev, tmp, data, index, smi: str) -> dict:
    """Evaluation from weight files with every artifact, at full re10k width,
    on the seeded test chunks of the data phase and its index: a seeded
    encoder tree in the JAX layout and a seeded LPIPS state dict are written,
    `main test` loads both and writes renders, videos, PLY, stage timing and
    the analysis (launch counts reset just before and read just after: K1,
    K3, K5 at P = 1 and 4, K7); the loaded encoder must equal the tree bit
    for bit, the staged encoder the fused one (STAGED_TOL), each PLY the
    encoder's Gaussians (PLY_TOL), each video 30 frames; a video's 30-view
    decode is held against the plain versions (K1's lists against the
    classic route's, K3 against the plain compositor) and measured (pairs,
    peak bytes, ms between CUDA events; its kernels' device times come from
    `decode_30_views`); then a second `main test` from seed-init weights
    and `main compute-metrics` over both runs' renders."""
    from pathlib import Path

    from transplat_tpu_torch import kernels
    from transplat_tpu_torch.config import CheckpointingCfg, load_config
    from transplat_tpu_torch.convert import to_jax_tree
    from transplat_tpu_torch.dataset.loader import CONTEXT_KEYS, DataLoader, batch_to_device
    from transplat_tpu_torch.evaluation import Evaluator
    from transplat_tpu_torch.evaluation.evaluator import video_cameras
    from transplat_tpu_torch.evaluation.staged import STAGES, StagedEncoder
    from transplat_tpu_torch.inference import init_random
    from transplat_tpu_torch.model.decoder import decode_splatting
    from transplat_tpu_torch.model.encoder import EncoderTranSplat
    from transplat_tpu_torch.ops.rasterizer import api, binning, composite
    from transplat_tpu_torch.training.schedule import make_lr_schedule
    from transplat_tpu_torch.training.step import create_train_state, make_optimizer
    from transplat_tpu_torch.utils.benchmarker import Benchmarker
    from transplat_tpu_torch.utils.image_io import load_video
    from transplat_tpu_torch.visualization.ply_export import ply_rows, read_ply

    times: dict[str, float] = {}
    tmp, data, index = Path(tmp), Path(data), Path(index)
    gc.collect()
    torch.cuda.empty_cache()
    with _Budget("eval_artifacts", times):
        t0 = time.perf_counter()
        cfg = load_config("re10k", test=dict(evaluation_index=str(index)), dataset=dict(roots=[str(data)]))
        seeded = EncoderTranSplat(cfg.encoder, device=dev)
        init_random(seeded, SEED + 7)
        tree = to_jax_tree(seeded)
        del seeded
        tree_path, lpips_path = tmp / "encoder_tree.npy", tmp / "lpips_vgg.npy"
        np.save(tree_path, tree, allow_pickle=True)
        np.save(lpips_path, seeded_lpips_state("torchvision", "", SEED + 8), allow_pickle=True)
        write_s = time.perf_counter() - t0

        out = tmp / "eval_weights"
        weights = [f"checkpointing.pretrained_model={tree_path}", f"checkpointing.lpips_weights={lpips_path}"]
        artifacts = ["test.stage_timing=true", "test.analyze=true", "test.save_video=true", "test.save_ply=true"]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc, printed = _main_quiet(["test", "--dataset-root", str(data), "--evaluation-index", str(index),
                                   "--output", str(out), "--save-image", *weights, *artifacts])
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        require(rc == 0, f"eval_artifacts: main test exited {rc}")
        require(f"loaded pretrained weights: model={tree_path}" in printed and "lpips: weights from" in printed,
                "eval_artifacts: main test did not report the weight files")
        for name in ("bin_count", "bin_scan", "bin_place", "composite", "deform_scores_p1", "deform_scores_p4",
                     "deform_vectors"):
            require(launches.get(name, 0) > 0, f"eval_artifacts: kernel {name} was not launched by main test")

        # the loaded encoder is the tree, bit for bit
        optimizer = make_optimizer(make_lr_schedule(cfg.optimizer.lr, 1000))
        state = create_train_state(cfg.encoder, optimizer, None, device=dev, seed=0,
                                   ckpt_cfg=CheckpointingCfg(pretrained_model=str(tree_path)))
        encoder = state.encoder.eval()
        loaded, want = _flat_tree(to_jax_tree(encoder)), _flat_tree(tree)
        require(sorted(loaded) == sorted(want) and all(np.array_equal(loaded[k], want[k]) for k in want),
                "eval_artifacts: the loaded encoder differs from the tree")
        del state, tree, loaded, want

        scores = json.loads((out / "scores_per_scene.json").read_text())
        scenes = sorted(scores)
        entries = json.loads(index.read_text())
        require(len(scenes) == 2 and all(np.isfinite(scores[s]["lpips"]) for s in scenes),
                f"eval_artifacts: scores {scores}")
        bench_json = json.loads((out / "benchmark.json").read_text())
        require(set(STAGES) <= set(bench_json["summary"]), f"eval_artifacts: benchmark.json has {sorted(bench_json['summary'])}")
        for name in ("analysis_per_scene.json", "analysis_avg.json"):
            require((out / name).is_file(), f"eval_artifacts: no {name}")

        ev = Evaluator(cfg, encoder, None, device=dev)
        ply_err, staged_err, stage_records, decode30 = 0.0, None, None, None
        for batch in DataLoader(ev.make_dataset(), batch_size=1, drop_last=False):
            scene = batch["scene"][0]
            n_targets = len(entries[scene]["target"])
            pngs = sorted(p.name for p in (out / scene / "color").glob("*.png"))
            require(pngs == [f"{t:04d}.png" for t in range(n_targets)], f"eval_artifacts: {scene} PNGs {pngs}")
            for name in ("wobble", "interpolation"):
                frames = load_video(out / scene / f"{name}.mp4")
                require(frames.shape == (30, *IMAGE, 3), f"eval_artifacts: {scene} {name}.mp4 is {frames.shape}")
            ctx = batch_to_device(batch, dev)["context"]
            with torch.no_grad():
                gaussians, aux = encoder(*(ctx[k] for k in CONTEXT_KEYS), return_aux=True)
            names, rows = read_ply(out / scene / "gaussians.ply")
            want_names, want_rows = ply_rows(
                gaussians.means[0].cpu().numpy(), aux["scales"][0].cpu().numpy(), aux["rotations"][0].cpu().numpy(),
                gaussians.harmonics[0].cpu().numpy(), gaussians.opacities[0].cpu().numpy())
            require(names == want_names and rows.shape == (2 * IMAGE[0] * IMAGE[1], len(names)),
                    f"eval_artifacts: {scene} PLY holds {rows.shape}")
            err = float(np.max(np.abs(rows - want_rows) / (1.0 + np.abs(want_rows))))
            require(err <= PLY_TOL, f"eval_artifacts: {scene} PLY differs from the encoder's Gaussians by {err}")
            ply_err = max(ply_err, err)
            if staged_err is not None:
                continue

            # the staged encoder against the fused one, every stage timed and measured
            staged = StagedEncoder(encoder)
            bench = Benchmarker(dev)
            staged.run(ctx, benchmarker=bench)  # warm
            bench = Benchmarker(dev)
            staged_g, _ = staged.run(ctx, benchmarker=bench)
            staged_err = max(float(((a - b).abs() / (1.0 + b.abs())).max()) for a, b in zip(staged_g, gaussians))
            require(staged_err <= STAGED_TOL, f"eval_artifacts: staged vs fused encoder {staged_err} > {STAGED_TOL}")
            summary, memory, flops = bench.summarize(), staged.memory_analysis(), staged.cost_analysis()
            stage_records = {t: {"device_ms": summary[t]["mean_ms"], "peak_bytes": memory[t]["peak_bytes_in_use"],
                                 "peak_rise_bytes": memory[t]["stage_peak_delta"], "flops": flops[t]["flops"]}
                             for t in STAGES}

            # a video's 30-view decode: launches, pairs, peak bytes, device ms; K1 and K3 against plain versions
            extr, intr = (torch.from_numpy(x)[None].to(dev) for x in video_cameras(batch)["wobble"])
            near = torch.full((1, 30), float(batch["context"]["near"][0, 0]), device=dev)
            far = torch.full((1, 30), float(batch["context"]["far"][0, 0]), device=dev)

            def decode():
                return decode_splatting(gaussians, extr, intr, near, far, IMAGE, cfg=cfg.decoder)

            with torch.no_grad():
                decode()
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launches()
                color = decode().color
                torch.cuda.synchronize()
                decode_launches = {k: kernels.launches.get(k, 0) for k in ("bin_count", "bin_scan", "bin_place", "composite")}
                peak = torch.cuda.max_memory_allocated() - held
                require(all(v == 1 for v in decode_launches.values()), f"eval_artifacts: 30-view decode {decode_launches}")
                proj = api.project_views(extr[0], intr[0], near[0],
                                         *(x.expand(30, *x.shape[1:]).contiguous() for x in gaussians), IMAGE)
                gfeat, colors = binning.sort_by_depth(proj)
                lists = binning.bin_gaussians(gfeat, IMAGE)
                classic = binning.bin_gaussians_plain(gfeat, IMAGE)
                require(torch.equal(lists.idx, classic.idx) and torch.equal(lists.ranges, classic.ranges),
                        "eval_artifacts: K1's 30-view lists differ from the classic route's")
                bg = torch.zeros(30, 3, device=dev)
                plain, _, _ = composite.composite_tiles_plain(gfeat, colors, lists, bg, IMAGE)
                k3_err, k3_share = require_composite(color[0], plain, "eval_artifacts: 30-view decode")
                pairs = int(lists.idx.numel())
                del proj, gfeat, colors, lists, classic, plain
                decode_ms = time_ms(decode, iters=5, warmup=1)
            decode30 = {"views": 30, "gaussians": int(gaussians.means.shape[1]), "pairs": pairs, "launches": decode_launches,
                        "peak_bytes_above_held": peak, "decode_ms_events": decode_ms,
                        "k3_max_abs_err_vs_plain": k3_err, "k3_share_beyond_1e-5": k3_share,
                        "k1_lists_equal_classic_route": True}

        # a second run from seed-init weights, then compute-metrics over both runs' renders
        seeded_out = tmp / "eval_seeded"
        rc, _ = _main_quiet(["test", "--dataset-root", str(data), "--evaluation-index", str(index),
                             "--output", str(seeded_out), "--save-image"])
        require(rc == 0, f"eval_artifacts: the seed-init main test exited {rc}")
        metrics_dir = tmp / "metrics"
        rc, _ = _main_quiet(["compute-metrics", "--ground-truth", str(out), "--method", f"weights={out}",
                             "--method", f"seeded={seeded_out}", "--output", str(metrics_dir)])
        summary = json.loads((metrics_dir / "summary.json").read_text())
        require(rc == 0 and sorted(summary) == ["seeded", "weights"], f"eval_artifacts: compute-metrics {summary}")
        require(abs(summary["weights"]["psnr"] - PSNR_SATURATION_DB) < 1e-3,
                f"eval_artifacts: PSNR of the renders against themselves {summary['weights']['psnr']}")
        require(np.isfinite(summary["seeded"]["psnr"]) and summary["seeded"]["psnr"] < PSNR_SATURATION_DB,
                f"eval_artifacts: seed-init PSNR {summary['seeded']['psnr']}")
        del encoder, ev
    record = {"phase": "eval_artifacts", "card": smi, "scenes": scenes, "launches": launches,
              "stages": stage_records, "stage_ms_main_test": {t: bench_json["summary"][t]["mean_ms"] for t in STAGES},
              "staged_vs_fused_max_rel_err": staged_err, "staged_tolerance": STAGED_TOL,
              "ply_max_rel_err": ply_err, "ply_tolerance": PLY_TOL, "decode_30_views": decode30,
              "scores": scores, "compute_metrics": summary, "write_weights_s": write_s, "main_test_s": test_s,
              "seconds": times["eval_artifacts"]}
    emit(record)
    return record


def data_cli_phase(dev, records: list[dict], smi: str) -> None:
    """The data path and the command line at full re10k width, in a temporary
    directory: the native library and the JPEG route (one 360x640 batch
    decoded against its source and LANCZOS-rescaled), RE10K-format chunks
    from a seed written with that route's encoder, then
    `main generate-index` (every test scene gets an entry), `main train`
    (CLI_TRAIN_STEPS steps over the chunks with the default 4 forked
    workers; a validation reads a scene of the test split; a checkpoint;
    all twelve kernels launch), `main test` on that checkpoint (finite
    PSNR, SSIM, LPIPS for both test scenes), `main bench` (its line printed
    as is; every number finite and positive, `device` the card), and the
    loader's examples per second with 0 and 4 workers beside a training
    step's ms, and `eval_artifacts_phase` on the same chunks and index. Each
    part runs under its budget (DATA_BUDGET_S)."""
    import os
    import tempfile
    from pathlib import Path

    from transplat_tpu_torch import kernels, native
    from transplat_tpu_torch.config import load_config
    from transplat_tpu_torch.dataset import chunks
    from transplat_tpu_torch.training import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    times: dict[str, float] = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # main train writes outputs/latest-run under the working directory
        try:
            # 1. the native library and the JPEG route
            with _Budget("native", times):
                route = native.jpeg_route()  # builds and loads the route's library and the resizes
                source = chunks.panorama_frames(6, (360, 640), seed=SEED)
                blobs = native.encode_jpeg_batch(source, quality=95)
                native.decode_jpeg_batch(blobs)  # warm
                t0 = time.perf_counter()
                decoded = native.decode_jpeg_batch(blobs)
                decode_ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                small = native.resize_lanczos_batch(decoded, (256, 455))
                lanczos_ms = (time.perf_counter() - t0) * 1e3
                mae = float(np.abs(decoded.astype(np.float64) - source).mean()) / 255.0
                require(decoded.shape == source.shape and small.shape == (6, 256, 455, 3), "data: decoded shapes")
                require(mae <= JPEG_MAE_TOL, f"data: {route} decode differs from its source by {mae} > {JPEG_MAE_TOL}")
                truncated = blobs[0][: len(blobs[0]) // 2]
                try:
                    native.decode_jpeg_batch([truncated])
                    raise RuntimeError("check failed: data: a truncated JPEG decoded without an error")
                except ValueError:
                    pass
            emit({"phase": "data_native", "jpeg_route": route, "images": 6, "shape": [360, 640],
                  "decode_ms": decode_ms, "lanczos_to_256x455_ms": lanczos_ms, "decode_mean_abs_err": mae,
                  "tolerance": JPEG_MAE_TOL, "quality": 95, "seconds": times["native"]})

            # 2. chunks from a seed: the keys of the two splits differ
            data = Path(tmp) / "re10k"
            with _Budget("chunks", times):
                for i in range(TRAIN_SCENES):  # one chunk file each: two of the four workers read one
                    chunks.write_chunk(data / "train" / f"{i:06d}.torch",
                                       [chunks.make_scene(f"train_{i}", TRAIN_FRAMES, seed=SEED + i)])
                test_keys = [f"test_{i}" for i in range(TEST_SCENES)]
                chunks.write_chunk(data / "test" / "000000.torch",
                                   [chunks.make_scene(k, TEST_FRAMES, seed=SEED + 100 + i) for i, k in enumerate(test_keys)])

            # 3. generate-index
            index = Path(tmp) / "index.json"
            with _Budget("generate_index", times):
                rc, out = _main_quiet(["generate-index", "--dataset-root", str(data), "--output", str(index)])
            entries = json.loads(index.read_text())
            require(rc == 0 and sorted(entries) == test_keys and all(entries[k] for k in test_keys),
                    f"data: generate-index gave {entries}")

            # 4. train over the chunks, at full width, with the default workers
            run = Path(tmp) / "run"
            cfg = load_config("re10k")
            torch.cuda.synchronize()
            kernels.reset_launches()
            with _Budget("train", times):
                rc, out = _main_quiet(["train", "--dataset-root", str(data), "--max-steps", str(CLI_TRAIN_STEPS),
                                       "--output", str(run)])
                torch.cuda.synchronize()
            launches = dict(kernels.launches)
            require(rc == 0, f"data: main train exited {rc}")
            for name in FORWARD_KERNELS + BACKWARD_KERNELS:
                require(launches.get(name, 0) > 0, f"data: kernel {name} was not launched by main train")
            ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
            require(f"step_{CLI_TRAIN_STEPS:08d}.pt" in ckpts, f"data: checkpoints {ckpts}")
            lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
            vals = [r for r in lines if "val_psnr" in r]
            val_scenes = sorted({s for r in vals for s in r["val_scenes"]})
            require(vals and set(val_scenes) <= set(test_keys), f"data: validations read {val_scenes}")
            require(all(np.isfinite(r["val_psnr"]) for r in vals), "data: a validation's PSNR is not finite")
            require(f"JPEG route {route}, {cfg.trainer.num_workers} worker" in out, "data: main train's data line")
            for rec in records:
                rec["launches_cli_train"] = launches.get(rec["name"], 0)

            # 5. test on that checkpoint
            scores_dir = Path(tmp) / "scores"
            kernels.reset_launches()
            with _Budget("test", times):
                rc, out = _main_quiet(["test", "--dataset-root", str(data), "--evaluation-index", str(index),
                                       "--checkpoint", str(run / "checkpoints"), "--output", str(scores_dir)])
                torch.cuda.synchronize()
            test_launches = dict(kernels.launches)
            scores = json.loads((scores_dir / "scores_per_scene.json").read_text())
            require(rc == 0 and sorted(scores) == test_keys, f"data: main test scored {sorted(scores)}")
            for key, s in scores.items():
                require(all(np.isfinite(s[k]) for k in ("psnr", "ssim", "lpips")), f"data: scores of {key}: {s}")
            for name in ("bin_count", "bin_scan", "bin_place", "composite", "deform_scores_p1", "deform_vectors"):
                require(test_launches.get(name, 0) > 0, f"data: kernel {name} was not launched by main test")

            # 6. bench
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            with _Budget("bench", times):
                rc, out = _main_quiet(["bench"])
            bench_launches = dict(kernels.launches)
            bench_peak = torch.cuda.max_memory_allocated()
            line = out.strip().splitlines()[-1]
            print(line, flush=True)
            bench = json.loads(line)
            numbers = {k: v for k, v in bench.items() if isinstance(v, (int, float))}
            require(rc == 0 and all(np.isfinite(v) and v > 0 for v in numbers.values()), f"data: bench {bench}")
            require(bench["device"] == torch.cuda.get_device_name(0) and "train_step_ms" in bench,
                    f"data: bench device {bench.get('device')}")
            for name in ("bin_count", "bin_scan", "bin_place", "composite", "composite_bwd", "bin_bwd"):
                require(bench_launches.get(name, 0) > 0, f"data: kernel {name} was not launched by the bench")
            from transplat_tpu_torch import bench as port_bench
            from transplat_tpu_torch.ops.rasterizer import api, binning

            with torch.no_grad():
                scene = port_bench.bench_scene(8, 131_072, dev, seed=0)
                proj = api.project_views(scene["extrinsics"], scene["intrinsics"], scene["near"],
                                         *(scene[k] for k in port_bench.GAUSSIAN_KEYS), (256, 256))
                pairs = int(binning.bin_gaussians(binning.sort_by_depth(proj)[0], (256, 256), 16).idx.numel())
            del scene, proj
            emit({"phase": "bench", "peak_mem_bytes": bench_peak, "pairs": pairs, "views": 8, "gaussians": 131_072,
                  "launches": bench_launches, "seconds": times["bench"]})

            # 7. the loader's examples per second, 0 and 4 workers, at re10k shapes
            loader = {}
            with _Budget("loader", times):
                for nw in (4, 0):  # a thread of the 0-worker loader keeps filling its queue after it
                    lcfg = load_config("re10k", dataset=dict(roots=[str(data)]),
                                       trainer=dict(num_workers=nw),
                                       checkpointing=dict(save_dir=str(Path(tmp) / f"loader{nw}")))
                    trainer = Trainer(lcfg, log_fn=lambda m: None, device=dev)
                    it = trainer.train_batches()
                    next(it)  # workers started, first batch in
                    t0 = time.perf_counter()
                    for _ in range(LOADER_BATCHES):
                        batch = next(it)
                    dt = time.perf_counter() - t0
                    it.close()
                    b = batch["context"]["image"].shape[0]
                    require(batch["context"]["image"].shape == (b, 2, 256, 256, 3), "data: loader batch shape")
                    loader[nw] = LOADER_BATCHES * b / dt

            # 8. evaluation from weight files with every artifact, on these chunks
            eval_artifacts_phase(dev, tmp, data, index, smi)
        finally:
            os.chdir(cwd)
    emit({"phase": "data_cli", "jpeg_route": route, "seconds": times, "seconds_total": sum(times.values()),
          "train_steps": CLI_TRAIN_STEPS, "train_launches": launches, "validated_scenes": val_scenes,
          "checkpoints": ckpts, "index": entries, "test_scores": scores, "test_launches": test_launches,
          "loader_examples_per_s": {"workers_0": loader[0], "workers_4": loader[4]},
          "loader_ms_per_example": {"workers_0": 1e3 / loader[0], "workers_4": 1e3 / loader[4]},
          "train_step_ms_bench_b1": bench["train_step_ms"], "examples_per_train_step": cfg.trainer.batch_size, "frames": {"train": [TRAIN_SCENES, TRAIN_FRAMES],
                                                                        "test": [TEST_SCENES, TEST_FRAMES]}})


DTU_SCANS, DTU_FRAMES = 2, 6


def dtu_phase(records: list[dict], smi: str) -> None:
    """DTU's PNG chunks on the card: a chunk packed as scripts/convert_dtu.py
    packs it (DTU_SCANS scans of DTU_FRAMES PNG frames at the dtu config's
    360x640, and one 512x640 scan its shape check skips), then
    `main test --experiment dtu` with 3 context views (the dtu_nctx3 index's
    count) from seed-initialised full-width weights: launch counts reset
    just before and read just after (K1, K3, K5 at P = 1 and 4, K7; they
    join the kernels line as `launches_dtu`), a finite PSNR / SSIM / LPIPS
    for each 360x640 scan and none for the skipped one."""
    import os
    import tempfile
    from pathlib import Path

    from transplat_tpu_torch import kernels
    from transplat_tpu_torch.dataset import chunks

    gc.collect()
    torch.cuda.empty_cache()
    keys = [f"scan{i}" for i in range(DTU_SCANS)]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "dtu"
        scenes = [chunks.make_png_scene(k, DTU_FRAMES, SEED + i, (360, 640)) for i, k in enumerate(keys)]
        chunks.write_chunk(root / "test" / "000000.torch", [*scenes, chunks.make_png_scene("scan_big", DTU_FRAMES, SEED, (512, 640))])
        index = Path(tmp) / "evaluation_index_dtu_nctx3.json"
        index.write_text(json.dumps({k: {"context": [0, 2, 4], "target": [1, 3]} for k in [*keys, "scan_big"]}))
        out = Path(tmp) / "scores"
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            rc, printed = _main_quiet(["test", "--experiment", "dtu", "--dataset-root", str(root), "--evaluation-index",
                                       str(index), "--output", str(out), "encoder.num_context_views=3"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(kernels.launches)
        finally:
            os.chdir(cwd)
        require(rc == 0, f"dtu: main test exited {rc}: {printed[-2000:]}")
        per_scene = json.loads((out / "scores_per_scene.json").read_text())
    require(sorted(per_scene) == keys, f"dtu: scored {sorted(per_scene)}")
    require(all(np.isfinite(v[k]) for v in per_scene.values() for k in ("psnr", "ssim", "lpips")), "dtu: scores")
    for name in ("deform_scores_p1", "deform_scores_p4", "deform_vectors", "bin_count", "bin_scan", "bin_place",
                 "composite"):
        require(launches.get(name, 0) > 0, f"dtu: kernel {name} was not launched by main test")
    for rec in records:
        rec["launches_dtu"] = launches.get(rec["name"], 0)
    emit({"phase": "dtu", "card": smi, "scans": keys, "skipped": ["scan_big"], "context_views": 3, "frames": "PNG 360x640",
          "seconds": seconds, "launches": launches, "scores": per_scene})


# The parallel phase (parallel_phase). A dp x sp step on two gloo ranks that
# share the card against the one-process step on the joined batch, from the
# same seeded state (parallel.dryrun.step_errors): loss, gradient norm and
# the clipped gradient (whole, relative L2; its worst leaf among those that
# carry 1e-6 of its norm, relative), the update's cosine (parameters after
# the step less before), BatchNorm statistics, and an sp rank's colours from
# the sharded decode against the unsharded decode of its views. An sp
# rank's encoder forward is the one-process forward, so sp is held near
# float32's rounding. A dp rank's encoder runs each example in a batch of
# one where the joined step runs a batch of two, which rounds otherwise;
# the same step in float64 agrees within 1e-12 (tests/test_torch_parallel.py),
# so dp is held at a few times its float32 readings. Readings on an H100
# 80GB HBM3 at 700 W (PERF.md, section 6): dp norm 3.8e-6, gradient
# 1.9e-5, worst leaf 1.7e-3, update cosine 1 - 7.1e-6; sp norm 0, gradient
# 7.7e-7, worst leaf 1.7e-5, update cosine 1 - 5e-10.
_PARALLEL_COMMON = {"loss_rtol": 1e-5, "stats_atol": 1e-5, "color_atol": 1e-5}
PARALLEL_TOL = {
    "dp": {**_PARALLEL_COMMON, "grad_norm_rtol": 1e-5, "clipped_grad_rel_l2": 1e-4, "worst_leaf_rel": 1e-2,
           "update_cos_min": 1 - 5e-5},
    "sp": {**_PARALLEL_COMMON, "grad_norm_rtol": 1e-5, "clipped_grad_rel_l2": 1e-5, "worst_leaf_rel": 1e-4,
           "update_cos_min": 1 - 1e-6},
}
PARALLEL_STEPS_NCCL = 2
RASTER_KERNELS = ("bin_count", "bin_scan", "bin_place", "composite", "composite_bwd", "bin_bwd")


def _main_train_rank(argv: list[str]) -> dict:
    """One rank of `transplat_tpu_torch.main train` (spawned by parallel.launch):
    its exit code, the kernels it launched, seconds and peak bytes."""
    from transplat_tpu_torch import kernels

    kernels.reset_launches()
    t0 = time.perf_counter()
    rc, out = _main_quiet(argv)
    torch.cuda.synchronize()
    return {"rc": rc, "launches": dict(kernels.launches), "seconds": time.perf_counter() - t0,
            "peak_bytes": torch.cuda.max_memory_allocated(), "out": out[-2000:]}


def require_parallel(errs: dict, kind: str, label: str) -> None:
    """Fail unless `errs` (parallel.dryrun.step_errors) is within PARALLEL_TOL[kind] ("dp" or "sp")."""
    tol = PARALLEL_TOL[kind]
    require(errs["finite"] and errs["same_metrics_on_every_rank"] and errs["same_keys"],
            f"parallel {label}: metrics differ or not finite")
    for key, bound in (("loss_rel_err", "loss_rtol"), ("grad_norm_rel_err", "grad_norm_rtol"),
                       ("clipped_grad_rel_l2", "clipped_grad_rel_l2"), ("clipped_grad_worst_leaf_rel", "worst_leaf_rel"),
                       ("batch_norm_max_abs_err", "stats_atol"), ("color_max_abs_err", "color_atol")):
        require(errs[key] <= tol[bound], f"parallel {label}: {key} {errs[key]} > {tol[bound]}")
    require(errs["update_cosine"] >= tol["update_cos_min"], f"parallel {label}: update cosine {errs['update_cosine']}")


def _parallel_step_run(dp: int, sp: int, smi: str) -> dict:
    """A full-width dp x sp step on two gloo ranks of the card against the
    one-process step (taken twice: the card's floor) on the joined batch."""
    from transplat_tpu_torch.parallel import dryrun, launch

    kind = "sp" if sp > 1 else "dp"
    spec = dryrun.StepSpec(dp=dp, sp=sp, device="cuda", backend="gloo", full_width=True, num_target=NUM_TARGET,
                           dropout=sp > 1, return_params=True, decode_check=True)
    t0 = time.perf_counter()
    ranks = launch.spawn(dryrun.step_rank, dp * sp, spec, timeout_s=600, threads=4, local_ranks=False)
    ranks_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    refs = [dryrun.reference_step(spec) for _ in range(2)]
    errs = dryrun.step_errors(ranks, refs[0])
    errs["floor_grad_norm_rel"] = abs(refs[1]["metrics"]["grad_norm"] - refs[0]["metrics"]["grad_norm"]) / refs[0]["metrics"]["grad_norm"]
    ref, m, mr = refs[0], ranks[0]["metrics"], refs[0]["metrics"]
    rec = {"phase": "parallel", "run": f"dp{dp}_sp{sp}", "card": smi, "backend": "gloo", "ranks_on_one_card": dp * sp,
           "batch_per_rank": 1, "context": 2, "target_views": NUM_TARGET, "image": list(IMAGE),
           "loss": m["loss"], "loss_reference": mr["loss"], "grad_norm": m["grad_norm"],
           "grad_norm_reference": mr["grad_norm"], **errs, "tolerance": PARALLEL_TOL[kind],
           "ranks_seconds": ranks_s, "reference_ms_per_step": ref["ms_per_step"],
           "reference_peak_bytes": ref["peak_bytes"],
           "ranks": [{"rank": r["rank"], "dp_rank": r["dp_rank"], "sp_rank": r["sp_rank"],
                      "pairs": r["decode"]["pairs"], "views": r["decode"]["views"],
                      "gaussians_local": r["decode"]["gaussians_local"],
                      "k1_k4_launches": {k: r["launches"].get(k, 0) for k in RASTER_KERNELS},
                      "launches": r["launches"], "ms_per_step": r["ms_per_step"], "peak_bytes": r["peak_bytes"],
                      "all_reduce_bytes": r["all_reduce"]["bytes"], "all_reduce_ms": r["all_reduce"]["ms"],
                      "traffic": r["traffic"]} for r in ranks]}
    emit(rec)
    require_parallel(errs, kind, rec["run"])
    for r in ranks:
        for name in FORWARD_KERNELS + BACKWARD_KERNELS:
            require(r["launches"].get(name, 0) > 0, f"parallel {rec['run']}: rank {r['rank']} did not launch {name}")
    return rec


def parallel_phase(records: list[dict], smi: str) -> None:
    """Data parallelism and the view-sharded decode on the one card:
    (a) `main train --dp 1 --sp 1` at full width over seeded chunks, one rank
    spawned by the port's launch (torchrun's environment), NCCL at world size
    1, PARALLEL_STEPS_NCCL steps, every kernel launched; (b) dp = 2 x sp = 1
    and dp = 1 x sp = 2, one full-width step each on two processes sharing
    the card over gloo, against the one-process step (`_parallel_step_run`);
    (c) `dryrun_multichip(2)` on the card. The sp run's K1-K4 launches per
    rank join the kernels line (`launches_sp`)."""
    import os
    import tempfile
    from pathlib import Path

    from transplat_tpu_torch.dataset import chunks
    from transplat_tpu_torch.parallel import dryrun, launch

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "re10k"
        for i in range(TRAIN_SCENES):
            chunks.write_chunk(data / "train" / f"{i:06d}.torch",
                               [chunks.make_scene(f"train_{i}", TRAIN_FRAMES, seed=SEED + i)])
        run = Path(tmp) / "run"
        argv = ["train", "--dp", "1", "--sp", "1", "--dataset-root", str(data), "--max-steps", str(PARALLEL_STEPS_NCCL),
                "--output", str(run), "trainer.num_workers=0", "trainer.num_sanity_val_steps=0",
                "trainer.val_check_interval=1000"]
        cwd = os.getcwd()
        os.chdir(tmp)  # main train writes outputs/latest-run under the working directory
        try:
            (res,) = launch.spawn(_main_train_rank, 1, argv, timeout_s=600, threads=4)
        finally:
            os.chdir(cwd)
        require(res["rc"] == 0, f"parallel: main train --dp 1 --sp 1 exited {res['rc']}: {res['out']}")
        for name in FORWARD_KERNELS + BACKWARD_KERNELS:
            require(res["launches"].get(name, 0) > 0, f"parallel: main train --dp 1 --sp 1 did not launch {name}")
        ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
        require(f"step_{PARALLEL_STEPS_NCCL:08d}.pt" in ckpts, f"parallel: checkpoints {ckpts}")
        emit({"phase": "parallel", "run": "main_train_nccl_world1", "card": smi, "backend": "nccl", "steps": PARALLEL_STEPS_NCCL,
              "seconds": res["seconds"], "peak_bytes": res["peak_bytes"], "launches": res["launches"],
              "checkpoints": ckpts})

    runs = [_parallel_step_run(2, 1, smi), _parallel_step_run(1, 2, smi)]
    sp_launches = runs[1]["ranks"][0]["launches"]
    for rec in records:
        rec["launches_sp"] = sp_launches.get(rec["name"], 0)

    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(2, "cuda", timeout_s=600)
    for r in dry:
        require(r["decode"]["grad_norm"] > 0 and all(r["decode"]["launches"].get(k, 0) > 0 for k in RASTER_KERNELS),
                f"parallel: dryrun_multichip(2) decode launches {r['decode']['launches']}")
    emit({"phase": "parallel", "run": "dryrun_multichip_2", "card": smi, "backend": "gloo", "dp": dry[0]["dp"],
          "sp": dry[0]["sp"], "seconds": time.perf_counter() - t0, "loss": dry[0]["step"]["metrics"]["loss"],
          "ranks": [{"step_launches": r["step"]["launches"], "decode_launches": r["decode"]["launches"],
                     "decode_grad_norm": r["decode"]["grad_norm"], "ms_per_step": r["step"]["ms_per_step"],
                     "peak_bytes": r["step"]["peak_bytes"], "all_reduce_bytes": r["step"]["all_reduce"]["bytes"],
                     "all_reduce_ms": r["step"]["all_reduce"]["ms"]} for r in dry]})


# The stage tools' rows and the hand-written kernels each must launch, no other.
# The depth predictor's rows take the backbone's features as constants: the
# epipolar matching (K5 at P = 1) has no parameter before it there, so its
# backward (K6 at P = 1) runs only in the encoder's.
MATCHING_FWD = frozenset({"deform_scores_p1", "deform_scores_p4", "deform_vectors"})
MATCHING_PARAMS_BWD = MATCHING_FWD | {"deform_scores_bwd_p4", "deform_vectors_bwd"}
MATCHING_BWD = MATCHING_PARAMS_BWD | {"deform_scores_bwd_p1"}
RENDER_FWD = frozenset({"bin_count", "bin_scan", "bin_place", "composite"})
RENDER_BWD = RENDER_FWD | {"composite_bwd", "bin_bwd"}
STAGE_KERNELS = {
    "encoder_4b_cost_volume_matching": MATCHING_FWD, "decoder": RENDER_FWD,
    "depth_pred fwd": MATCHING_FWD, "depth_pred fwd+bwd": MATCHING_PARAMS_BWD,
    "4b matching fwd": MATCHING_FWD, "4b matching fwd+bwd": MATCHING_PARAMS_BWD,
    "encoder fwd": MATCHING_FWD, "encoder fwd+bwd": MATCHING_BWD,
    "render fwd": RENDER_FWD, "render fwd+bwd": RENDER_BWD,
}
STAGE_ITERS = 2
LOADER_CHUNKS = 8  # one for each of 8 workers
LOADER_MEASURE_BATCHES = 6


def require_stage_launches(tool: str, rows: list[dict]) -> None:
    for row in rows:
        got = {k for k, v in row["launches"].items() if v > 0}
        want = STAGE_KERNELS.get(row["stage"], frozenset())
        require(got == want, f"{tool} {row['stage']}: launched {sorted(got)}, expected {sorted(want)}")


def stage_attribution(dev, smi: str, train: dict) -> None:
    """The stage tools in process at full re10k width, STAGE_ITERS timed calls
    a row: profile_stages (its staged Gaussians equal the fused encoder's bit
    for bit; its peak_memory.json's lifetime peak at least every stage's
    peak), bench_encoder_stages, bench_dp_stages in float32 and bfloat16,
    bench_train_stages (its largest sub-graph peak at most the train_slice
    step's) and bench_dataloader against the train_slice step's median. Each
    row's hand-written kernel launches must be STAGE_KERNELS' (none for a row
    not named there). One record per tool."""
    import tempfile
    from pathlib import Path

    from transplat_tpu_torch import (
        bench_dataloader,
        bench_dp_stages,
        bench_encoder_stages,
        bench_train_stages,
        kernels,
        profile_stages,
    )
    from transplat_tpu_torch.loss import LPIPS
    from transplat_tpu_torch.utils.stage_timing import time_rows

    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launches()  # each row reads its own launches as a difference of the counts
    seconds = {}

    def record(tool: str, rows: list[dict], t0: float, **extra) -> None:
        require_stage_launches(tool, rows)
        seconds[tool] = time.perf_counter() - t0
        emit({"phase": "stage_attribution", "tool": tool, "iters": STAGE_ITERS, "nvidia_smi": smi,
              "seconds": seconds[tool], "rows": rows, **extra})

    t0 = time.perf_counter()
    encoder, batch = profile_stages.build(False, dev, SEED)
    result = profile_stages.profile(encoder, batch, STAGE_ITERS, dev)
    with torch.no_grad():
        fused = encoder(*(torch.as_tensor(batch["context"][k], device=dev)
                          for k in ("image", "intrinsics", "extrinsics", "near", "far")))
    require(all(torch.equal(a, b) for a, b in zip(result["gaussians"], fused)),
            "stage_attribution: the staged Gaussians are not the fused encoder's bit for bit")
    with tempfile.TemporaryDirectory() as tmp:
        mem_path = profile_stages.write(result, Path(tmp) / "stage_profile.json", STAGE_ITERS)
        dump = json.loads(mem_path.read_text())
    stage_peaks = {t: r["peak_bytes_in_use"] for t, r in dump["stages"].items()}
    lifetime = dump["device"]["peak_bytes_in_use"]
    require(lifetime >= max(stage_peaks.values()), f"stage_attribution: dump's lifetime peak {lifetime} under "
            f"a stage's {max(stage_peaks.values())}")
    record("profile_stages", result["rows"], t0, staged_equals_fused=True, lifetime_peak_bytes=lifetime,
           stage_peak_bytes=stage_peaks)
    del result, fused

    t0 = time.perf_counter()
    rows = time_rows(bench_encoder_stages.subgraphs(encoder, batch, dev).items(), dev, STAGE_ITERS)
    record("bench_encoder_stages", rows, t0)

    t0 = time.perf_counter()
    rows = time_rows(bench_dp_stages.subgraphs(encoder, batch, dev).items(), dev, STAGE_ITERS)
    record("bench_dp_stages", rows, t0, compute_dtype="float32")

    t0 = time.perf_counter()
    lpips = LPIPS(device=dev, seed=SEED)
    rows = time_rows(bench_train_stages.subgraphs(encoder, lpips, batch, dev).items(), dev, STAGE_ITERS)
    largest = max(r["peak_bytes"] for r in rows)
    require(largest <= train["peak_mem_bytes"], f"stage_attribution: a train sub-graph's peak {largest} over "
            f"the train_slice step's {train['peak_mem_bytes']}")
    record("bench_train_stages", rows, t0, largest_peak_bytes=largest, train_step_peak_bytes=train["peak_mem_bytes"])
    del encoder, lpips
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    encoder, batch = bench_dp_stages.build(False, dev, "bf16", SEED)
    rows = time_rows(bench_dp_stages.subgraphs(encoder, batch, dev).items(), dev, STAGE_ITERS)
    record("bench_dp_stages_bf16", rows, t0, compute_dtype="bfloat16")
    del encoder
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    loader = bench_dataloader.run(train["ms_per_step"], dev, chunks=LOADER_CHUNKS,
                                  measure_batches=LOADER_MEASURE_BATCHES)
    require(all(v > 0 for v in loader["examples_per_s"].values()), f"stage_attribution: loader {loader}")
    seconds["bench_dataloader"] = time.perf_counter() - t0
    emit({"phase": "stage_attribution", "nvidia_smi": smi, "seconds": seconds["bench_dataloader"], **loader})
    emit({"phase": "stage_attribution", "seconds": seconds, "seconds_total": sum(seconds.values())})


def tiny_train_vs_cpu(dev) -> None:
    """One training step's loss and gradients (dropout off) at a tiny width:
    the kernels on the card against the plain versions on the CPU, from the
    same state."""
    from transplat_tpu_torch import kernels
    from transplat_tpu_torch.inference import re10k_decoder_cfg
    from transplat_tpu_torch.loss import LossCfg
    from transplat_tpu_torch.train_demo import build, tiny_encoder_cfg
    from transplat_tpu_torch.training.step import loss_and_grads

    cfg, shape = tiny_encoder_cfg(), (64, 64)
    st_gpu, _, batch_gpu, _ = build(cfg, shape, dev, SEED + 3, num_target=2)
    with torch.no_grad():  # keep depths off the 1/far clip, where 1/disparity amplifies rounding
        st_gpu.encoder.depth_predictor.to_disparity_2.weight[0] *= 0.01
    st_cpu, _, batch_cpu, _ = build(cfg, shape, "cpu", SEED + 3, num_target=2)
    st_cpu.encoder.load_state_dict(st_gpu.encoder.state_dict())
    st_cpu.lpips.load_state_dict(st_gpu.lpips.state_dict())
    batch_cpu = {side: {k: v.cpu() for k, v in views.items()} for side, views in batch_gpu.items()}
    kernels.reset_launches()
    args = (LossCfg(), re10k_decoder_cfg(), shape)
    metrics_g, grads_g = loss_and_grads(st_gpu, batch_gpu, *args, deterministic=True)
    metrics_c, grads_c = loss_and_grads(st_cpu, batch_cpu, *args, deterministic=True)
    loss_g, loss_c = metrics_g["loss"], metrics_c["loss"]
    for name in FORWARD_KERNELS + BACKWARD_KERNELS:
        require(kernels.launches.get(name, 0) > 0, f"tiny_train_vs_cpu: kernel {name} was not launched")
    # The rendered image is a step function of the Gaussians (integer cutoff
    # radius, 1/255 alpha floor): ~1.5% of its values differ between card and
    # CPU end to end in the worst case, and every gradient inherits those
    # flipped terms. Bounds (those of tests/test_torch_training.py against
    # JAX): loss within 1e-4 relative; the whole gradient within 0.01 of its
    # norm; every leaf within 0.05 of its own norm plus 5e-4 of the whole
    # gradient's (a bias in front of a normalisation has a gradient of pure
    # rounding noise, which no relative bound can hold).
    rel_loss = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    require(rel_loss <= 1e-4, f"tiny_train_vs_cpu: loss {float(loss_g)} vs {float(loss_c)}")
    diffs = {k: float((grads_g[k].cpu() - gc).norm()) for k, gc in grads_c.items()}
    norms = {k: float(gc.norm()) for k, gc in grads_c.items()}
    require(all(np.isfinite(d) for d in diffs.values()), "tiny_train_vs_cpu: non-finite gradients on the card")
    whole = sum(n**2 for n in norms.values()) ** 0.5
    total = sum(d**2 for d in diffs.values()) ** 0.5 / whole
    leaf_err = {k: diffs[k] / (norms[k] + 1e-2 * whole) for k in diffs}
    worst = max(leaf_err, key=leaf_err.get)
    require(leaf_err[worst] <= 0.05, f"tiny_train_vs_cpu: gradient of {worst} differs by {leaf_err[worst]} of its norm")
    require(total <= 0.01, f"tiny_train_vs_cpu: the whole gradient differs by {total} of its norm")
    emit({"phase": "tiny_train_vs_cpu", "loss_card": float(loss_g), "loss_cpu": float(loss_c), "loss_rel_err": rel_loss,
          "leaves": len(grads_c), "worst_leaf": worst, "worst_leaf_rel_l2": leaf_err[worst], "whole_gradient_rel_l2": total,
          "tolerance": "loss 1e-4 relative; each leaf 0.05 of (its norm + 1e-2 of the whole gradient's); whole gradient 0.01 of its norm"})


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
    require(tuple(out.shape) == (1, NUM_TARGET, *IMAGE, 3), f"output shape {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), "non-finite output")
    for name in FORWARD_KERNELS:
        require(launches.get(name, 0) > 0, f"kernel {name} was not launched on the main path")
    with torch.no_grad():
        gaussians = encoder(*(torch.as_tensor(ctx[k], device=dev) for k in ("image", "intrinsics", "extrinsics", "near", "far")))
    g = gaussians.means.shape[1]
    require(g == 2 * IMAGE[0] * IMAGE[1], f"{g} Gaussians")
    emit({"phase": "slice", "requests": REQUESTS, "ms_per_request": float(np.median(times)), "ms_all": times,
          "peak_mem_bytes": peak, "gaussians": g, "output_shape": list(out.shape), "finite": True,
          "launches": launches})

    # ---- every kernel against its plain version ---------------------------
    # K5 at P = 1 on the encoder's own epipolar locations too (not in the kernels line).
    check_deform(dev, 1, launches, encoder_score_inputs(encoder, ctx, dev, 1), "the encoder's epipolar locations")
    # K6 at P = 4 on the encoder's own cross-attention locations, and at a shape of its general path (not in the line).
    check_deform_bwd(dev, 4, encoder_score_inputs(encoder, ctx, dev, 4), "the encoder's cross-attention locations")
    check_deform_bwd_general(dev)
    records = [check_deform(dev, 1, launches), check_deform(dev, 4, launches),
               check_deform_bwd(dev, 1), check_deform_bwd(dev, 4),
               check_deform_vectors(dev, launches), *check_deform_vectors_bwd(dev)]
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
    check_binning_scenes(dev)
    decode_30_views(encoder, batch, dev, smi)
    media_kernels = validation_media_kernels(encoder, dev, smi)

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

    del enc_gpu, enc_cpu, encoder, gaussians, proj
    torch.cuda.empty_cache()

    # ---- the training path -------------------------------------------------
    train = train_slice(dev, records)
    train_deterministic(dev, records)
    precision_remat(dev, records)
    tiny_train_vs_cpu(dev)

    # ---- stage attribution: the stage tools at full width ----------------------
    stage_attribution(dev, smi, train)

    # ---- fit -> validate -> checkpoint -> resume -> evaluate ----------------
    fit_slice(dev, records, smi, media_kernels)
    fit_resume_deterministic(dev, records)

    # ---- the checkpoint converter's command line ------------------------------
    convert_weights_phase()

    # ---- the data path and the command line ----------------------------------
    data_cli_phase(dev, records, smi)

    # ---- DTU's PNG chunks ----------------------------------------------------------
    dtu_phase(records, smi)

    # ---- data parallelism and the view-sharded decode -------------------------
    parallel_phase(records, smi)

    print(smi, flush=True)
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
