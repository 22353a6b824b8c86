"""Depth-predictor sub-stage attribution, forward and forward + backward,
in float32 or bfloat16.

    python -m transplat_tpu_torch.bench_dp_stages [--iters 8] [--dtype f32|bf16] [--tiny] [--device cuda|cpu]

Counterpart of scripts/bench_dp_stages.py: the seeded re10k depth predictor
(b = 1, 2 views, 64x64x128 features, 256x256 images, DINO features
63x63x64; the tiny configuration at 64x64 with --tiny) on seeded random
inputs (`inputs`: numpy, as the JAX script's draws: features and CNN
features N(0, 0.25), DAv2 depth U(0, 1), DINO features N(0, 0.25)) times
4b matching forward and forward + backward, 4c the cost U-Net forward +
backward, 4e refine forward and forward + backward and 4f the heads
forward + backward (`DepthPredictor.prep / matching / cost_unet /
coarse_depth / refine / heads`), each on the outputs of the stages before
it, computed once. A backward is the gradient of sum(x^2) * 1e-6 over the
stage's outputs (in float32) with respect to the depth predictor's
parameters. `--dtype` sets the encoder's compute_dtype (default: the
configuration's, float32). Rows as bench_encoder_stages.py's.

The JAX script's `--s2d` (space-to-depth U-Net convolutions) is a TPU
workaround that the port leaves out (ROADMAP's north star): the flag is
refused.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .utils.stage_timing import (
    add_device_arg,
    device_name,
    gradient_of,
    print_rows,
    resolve_device,
    scalarize,
    seeded_encoder,
    time_rows,
    trainable,
)

ROWS = ("4b matching fwd", "4b matching fwd+bwd", "4c cost_unet fwd+bwd", "4e refine fwd", "4e refine fwd+bwd",
        "4f heads fwd+bwd")
DTYPES = {"f32": "float32", "bf16": "bfloat16"}
CONTEXT_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


def build(tiny: bool, device, dtype: str | None = None, seed: int = 0):
    """(encoder, batch): the seeded encoder at compute dtype `dtype` (f32 /
    bf16; None: the configuration's) and one synthetic batch."""
    from .dataset import synthetic_batch

    batch = synthetic_batch(seed, batch_size=1, image_shape=(64, 64) if tiny else (256, 256))
    return seeded_encoder(tiny, device, seed, None if dtype is None else DTYPES[dtype]), batch


def inputs(cfg, image_shape, seed: int = 1) -> dict:
    """The sub-stages' random inputs for an encoder configuration, as numpy
    (b = 1, 2 views): features and cnn_features (b, v, H/4, W/4, C), da_depth
    (b, v, H, W, 1), dino_feature (b, v, S/4, S/4, DAv2 features / 2)."""
    from .model.dav2 import DAV2_CONFIGS

    b, v = 1, cfg.num_context_views
    h, w = image_shape
    hf, wf, c = h // cfg.downscale_factor, w // cfg.downscale_factor, cfg.d_feature
    sd, cd = cfg.dav2_input_size // 4, DAV2_CONFIGS[cfg.dav2_encoder]["features"] // 2
    rng = np.random.default_rng(seed)
    return {
        "features": (rng.standard_normal((b, v, hf, wf, c)) * 0.5).astype(np.float32),
        "cnn_features": (rng.standard_normal((b, v, hf, wf, c)) * 0.5).astype(np.float32),
        "da_depth": rng.random((b, v, h, w, 1)).astype(np.float32),
        "dino_feature": (rng.standard_normal((b, v, sd, sd, cd)) * 0.5).astype(np.float32),
    }


def subgraphs(encoder, batch: dict, device, seed: int = 1) -> dict:
    """{row name: fn()}: forward rows return the stage's outputs, forward +
    backward rows the gradients ({parameter name in `encoder`: tensor})."""
    dp = encoder.depth_predictor
    images, intrinsics, extrinsics, near, far = (torch.as_tensor(batch["context"][k], device=device)
                                                 for k in CONTEXT_KEYS)
    h, w = images.shape[2:4]
    x = {k: torch.from_numpy(a).to(device) for k, a in inputs(encoder.cfg, (h, w), seed).items()}
    features = x["features"]
    hw = tuple(features.shape[2:4])
    with torch.no_grad():
        prep = dp.prep(features, intrinsics, extrinsics, near, far, x["dino_feature"])
        corr = dp.matching(prep, hw)
        raw_corr = dp.cost_unet(corr, features)
        coarse = dp.coarse_depth(raw_corr, prep["disp_candidates"], (h, w))
        refine_out, proj_full = dp.refine(features, x["cnn_features"], images, x["da_depth"], coarse)
    params = trainable(encoder, "depth_predictor")

    def matching():
        return dp.matching(prep, hw)

    def refine():
        return dp.refine(features, x["cnn_features"], images, x["da_depth"], coarse)

    def heads():
        return dp.heads(refine_out, proj_full, images, coarse["fullres_disps"], near, far)

    return dict(zip(ROWS, (
        torch.no_grad()(matching),
        gradient_of(lambda: scalarize(matching()), params),
        gradient_of(lambda: scalarize(dp.cost_unet(corr, features)), params),
        torch.no_grad()(refine),
        gradient_of(lambda: scalarize(refine()), params),
        gradient_of(lambda: scalarize(heads()), params),
    )))


def run(device, iters: int = 8, dtype: str | None = None, tiny: bool = False, seed: int = 0) -> dict:
    encoder, batch = build(tiny, device, dtype, seed)
    rows = time_rows(subgraphs(encoder, batch, device).items(), device, iters)
    return {"tool": "bench_dp_stages", "device": device_name(device), "iters": iters,
            "compute_dtype": encoder.cfg.compute_dtype, "rows": rows}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--dtype", choices=sorted(DTYPES), default=None, help="the encoder's compute dtype")
    parser.add_argument("--s2d", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--tiny", action="store_true", help="the tiny configuration at 64x64 (CPU runs)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if args.s2d:
        parser.error("--s2d: space-to-depth convolutions are a TPU workaround that the port leaves out")
    device = resolve_device(args.device, "bench_dp_stages")
    result = run(device, args.iters, args.dtype, args.tiny)
    print(f"compute dtype: {result['compute_dtype']}")
    print_rows(result["rows"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
