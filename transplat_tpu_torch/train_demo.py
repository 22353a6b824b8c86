"""A few training steps on synthetic posed batches.

    python -m transplat_tpu_torch.train_demo [--steps N] [--device cpu] [--tiny] [--deterministic-kernels]

Counterpart of scripts/bench_train_step.py of the JAX package: the re10k
configuration at full width (`--tiny`: a narrow encoder at 64x64, for a CPU),
random weights from `--seed`, random-init LPIPS (calibrated LPIPS weights
are not part of the repository), `synthetic_batch` with 2 context and 4
target views, MSE + 0.05 LPIPS, clip 0.5 + Adam under the one-cycle
schedule, dropout on. Prints one JSON line per step and a summary line.
Runs on the card unless `--device cpu` is given. `--deterministic-kernels`
makes every step repeat its bits (trainer.deterministic_kernels).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import kernels
from .dataset import batch_to_device, synthetic_batch
from .inference import init_random, re10k_decoder_cfg, re10k_encoder_cfg
from .loss import LPIPS, LossCfg
from .model.adapter import GaussianAdapterCfg
from .model.encoder import EncoderCfg
from .training import create_train_state, make_lr_schedule, make_optimizer, make_train_step

RE10K_LR = 2e-4
RE10K_MAX_STEPS = 300_001


def tiny_encoder_cfg() -> EncoderCfg:
    """A narrow, shallow encoder for CPU runs and tests (64x64 images)."""
    return EncoderCfg(
        d_feature=16, num_depth_candidates=16, costvolume_unet_feat_dim=16, costvolume_unet_channel_mult=(1, 1),
        costvolume_unet_attn_res=(2,), depth_unet_feat_dim=8, depth_unet_attn_res=(4,),
        depth_unet_channel_mult=(1, 1, 1), dav2_encoder="vits", dav2_input_size=28,
        gaussian_adapter=GaussianAdapterCfg(sh_degree=1),
    )


def build(encoder_cfg: EncoderCfg, image_shape, device, seed: int, num_target: int = 4,
          deterministic_kernels: bool = False):
    """(state, train_step, batch, generator): a seeded trainer on one fixed synthetic batch."""
    optimizer = make_optimizer(make_lr_schedule(RE10K_LR, RE10K_MAX_STEPS), grad_clip=0.5)
    state = create_train_state(encoder_cfg, optimizer, LPIPS(device=device, seed=seed), device=device)
    init_random(state.encoder, seed)
    step = make_train_step(
        encoder_cfg, LossCfg(), re10k_decoder_cfg(), optimizer, image_shape, deterministic_kernels=deterministic_kernels
    )
    batch = batch_to_device(
        synthetic_batch(seed, batch_size=1, num_context=2, num_target=num_target, image_shape=image_shape), device
    )
    return state, step, batch, torch.Generator(device=device).manual_seed(seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="narrow encoder at 64x64 (for a CPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deterministic-kernels", action="store_true", help="steps that repeat their bits")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        kernels.strict_float32()
    cfg, image_shape = (tiny_encoder_cfg(), (64, 64)) if args.tiny else (re10k_encoder_cfg(), (256, 256))
    state, step, batch, gen = build(cfg, image_shape, device, args.seed, deterministic_kernels=args.deterministic_kernels)
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        record = {k: float(v) for k, v in metrics.items()}  # reads the values: waits for the device
        times.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({"step": state.step, "ms": times[-1], **record}), flush=True)
    summary = {"device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu", "steps": args.steps, "ms_all": times}
    if device.type == "cuda":
        summary["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
