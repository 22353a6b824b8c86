"""Where the time of one full-width training step goes, on the card.

    python -m transplat_tpu_torch.profile_training [--steps 3] [--compute-dtype bfloat16] [--remat]

Builds the seeded re10k trainer of train_demo.py (random weights, random-init
LPIPS, one fixed synthetic batch of 2 context and 4 target views at 256x256),
takes one warm-up step, times `--steps` steps without the profiler (host
clock, each ending in a synchronize), then traces as many with
torch.profiler. Prints one JSON line per stage and per top device kernel,
and a summary line. `--compute-dtype` and `--remat` set the encoder's
compute_dtype and both checkpoints (remat_unet, remat_matching); the step
then runs with s2d_unet off, which the port ignores anyway.

Stages are the spans training/step.py records: the encoder, the decoder and
the losses of the forward, the backward, and the optimizer. Their host times
are inflated by the profiler (the summary gives the traced wall time beside
the unprofiled one). Autograd launches the backward's kernels from its own
thread, so the device spans of `train.backward` and of the whole `step` do
not cover them: read the device's busy time from the summary instead. It
and the idle share are taken as in profile_serving.py.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .profile_serving import report

SEED = 0
SPANS = ("step", "train.encoder", "train.decoder", "train.loss", "train.backward", "train.optimizer")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--remat", action="store_true", help="checkpoint the U-Nets and the UV fine layers")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_training: needs a CUDA card")

    from .inference import re10k_encoder_cfg
    from .train_demo import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(re10k_encoder_cfg(), s2d_unet=False, compute_dtype=args.compute_dtype,
                              remat_unet=args.remat, remat_matching=args.remat)
    state, train_step, batch, gen = build(cfg, (256, 256), "cuda", SEED)

    def step():
        with record_function("step"):
            train_step(state, batch, gen)

    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(times))
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        traced_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    busy_ms, summed_ms = report(prof, SPANS, (), args.steps, args.top, min(wall_ms, traced_wall_ms))
    device_events = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    print(json.dumps({
        "summary": "per step", "compute_dtype": args.compute_dtype, "remat": args.remat, "steps": args.steps,
        "device_events_per_step": device_events / args.steps, "wall_ms": wall_ms, "wall_ms_all": times,
        "traced_wall_ms": traced_wall_ms, "device_busy_ms": busy_ms, "device_summed_ms": summed_ms,
        "idle_share": 1.0 - busy_ms / wall_ms, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "device": torch.cuda.get_device_name(0),
    }))


if __name__ == "__main__":
    main()
