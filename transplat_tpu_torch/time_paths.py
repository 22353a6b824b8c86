"""Time full-width requests and training steps of this tree on the card.

    python -m transplat_tpu_torch.time_paths [--requests 30] [--steps 10] [--label NAME] [--deterministic-kernels]

Prints one JSON line: the median and quartiles of the request time (the
serving path of chip_smoke.py: 2 context views at 256x256 -> 4 target views,
seeded random weights) and of the training step time (train_demo's seeded
trainer), each after a warm-up, by a host clock around work that ends in a
synchronize. Host times spread between processes and machines: to compare
two trees, run this from each of them in turns (parent, change, change,
parent) on one card, back to back, and compare the processes' medians.
`--deterministic-kernels` times the steps with trainer.deterministic_kernels
on (a tree that has the switch).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .dataset import synthetic_batch
from .inference import init_random, re10k_encoder_cfg, render_novel_views
from .model.encoder import EncoderTranSplat
from .train_demo import build

IMAGE = (256, 256)


def _summary(ms: list[float]) -> dict:
    return {"median_ms": float(np.median(ms)), "q1_q3_ms": [float(np.percentile(ms, 25)), float(np.percentile(ms, 75))]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--label", default="")
    ap.add_argument("--deterministic-kernels", action="store_true")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    encoder = EncoderTranSplat(re10k_encoder_cfg(), device="cuda")
    init_random(encoder, 0)
    batch = synthetic_batch(0, batch_size=1, num_context=2, num_target=4, image_shape=IMAGE)
    request_ms = []
    for i in range(3 + args.requests):  # three warm-up requests
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_novel_views(encoder, batch["context"], batch["target"], IMAGE)
        torch.cuda.synchronize()
        if i >= 3:
            request_ms.append((time.perf_counter() - t0) * 1e3)
    del encoder

    switch = {"deterministic_kernels": True} if args.deterministic_kernels else {}
    state, step, train_batch, gen = build(re10k_encoder_cfg(), IMAGE, "cuda", 0, **switch)
    step_ms = []
    for i in range(2 + args.steps):  # two warm-up steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, train_batch, gen)
        torch.cuda.synchronize()
        if i >= 2:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({
        "label": args.label, "device": torch.cuda.get_device_name(0), "deterministic_kernels": args.deterministic_kernels,
        "request": {"count": args.requests, **_summary(request_ms)},
        "step": {"count": args.steps, **_summary(step_ms)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
