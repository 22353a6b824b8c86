"""Golden-scene overfit gate.

    python -m transplat_tpu_torch.overfit_golden [--steps 2000] [--size 256]
        [--lr 4e-4] [--min-psnr 25] [--no-cosine] [--out FILE] [--device cuda]

Counterpart of scripts/overfit_golden.py of the JAX package: overfits the
full re10k model on ONE parallax-consistent synthetic scene (textured planes
at mixed depths, dataset/loader.py `golden_scene_batch`) and tracks the
target-view PSNR of the training step. A model + rasterizer + optimizer
stack that cannot drive a 4-plane scene to high PSNR cannot learn a real
scene either, and a numerics change that every allclose test passes can
still cost decibels here.

Gate: the MEDIAN of the last 5 PSNR readings clears --min-psnr (a single
final step is noise: optimisation amplifies rounding differences). The
learning rate cosine-decays over the run after one warm-up step
(--no-cosine keeps it constant). No LPIPS term, as in the JAX script (no
calibrated weights). The same dropout generator state every step, as the
JAX script reuses one key. Exit status 1 when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from . import kernels
from .config import RootCfg, load_config
from .dataset import batch_to_device, golden_scene_batch
from .training import create_train_state, make_lr_schedule, make_optimizer, make_train_step


def main(argv=None, cfg: RootCfg | None = None) -> int:
    """`cfg`: another configuration than re10k's (the tests pass a narrow one)."""
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[2].replace("\n", " "),
        epilog="The JAX script's --capacity has no counterpart: the port's tile lists drop nothing.",
    )
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--min-psnr", type=float, default=25.0)
    ap.add_argument("--no-cosine", action="store_true", help="constant learning rate")
    ap.add_argument("--out", default="outputs/overfit_golden.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        kernels.strict_float32()
    cfg = cfg if cfg is not None else load_config("re10k")
    shape = (args.size, args.size)
    batch = batch_to_device(golden_scene_batch(image_shape=shape), device)

    schedule = make_lr_schedule(args.lr, args.steps, cosine=not args.no_cosine, warm_up_steps=1)
    optimizer = make_optimizer(schedule, cfg.optimizer.gradient_clip_val)
    state = create_train_state(cfg.encoder, optimizer, lpips=None, device=device, seed=0)
    step_fn = make_train_step(cfg.encoder, cfg.loss, cfg.decoder, optimizer, shape)

    gen = torch.Generator(device=device)
    curve = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        state, metrics = step_fn(state, batch, gen.manual_seed(1))
        # Dense readings over the last 25 steps feed the median-of-last-5 gate.
        if i % 25 == 0 or i >= args.steps - 25 and i % 5 == 4 or i == args.steps - 1:
            psnr, loss, overflow = float(metrics["psnr"]), float(metrics["loss"]), int(metrics["render_overflow"])
            curve.append({"step": i, "psnr": round(psnr, 3), "loss": round(loss, 5), "overflow": overflow})
            print(f"step {i:4d}: psnr {psnr:6.2f} loss {loss:.5f} overflow {overflow}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    last5 = sorted(c["psnr"] for c in curve[-5:])
    gate_psnr = last5[len(last5) // 2]
    record = {
        "steps": args.steps,
        "size": args.size,
        "cosine": not args.no_cosine,
        "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
        "final_psnr": curve[-1]["psnr"],
        "gate_psnr_median_last5": gate_psnr,
        "wall_s": round(wall, 1),
        "curve": curve,
        "passed": gate_psnr >= args.min_psnr,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
    print(json.dumps({k: record[k] for k in ("final_psnr", "gate_psnr_median_last5", "wall_s", "passed", "device")}))
    if not record["passed"]:
        print(f"FAIL: median-of-last-5 PSNR {gate_psnr:.2f} < {args.min_psnr}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
