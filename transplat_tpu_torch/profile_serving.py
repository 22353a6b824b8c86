"""Where the time of one full-width serving request goes, on the card.

    python -m transplat_tpu_torch.profile_serving [--requests 5]

Builds the re10k encoder with the seeded random weights of chip_smoke.py
(`inference.init_random`), serves one warm-up request (2 context views at
256x256 -> 131,072 Gaussians -> 4 target views at 256x256), times
`--requests` requests without the profiler (host clock, each ending in a
synchronize), then traces as many with torch.profiler. Prints one JSON line
per stage and per top device kernel, and a summary line.

Stages are spans recorded with record_function: the request, the encoder and
its parts (backbone, DAv2 prior, depth predictor with its UV matcher and two
U-Nets). What the encoder does outside its parts (preprocessing, adapter)
and the decoder (projection, sorts, binning, compositing) are printed as the
differences of spans; nothing inside them is attributed.

The device's busy time is the union of the intervals of the device events
(kernels, copies, sets) in the traced window, per request. Its idle share is
taken against the unprofiled wall time, since tracing slows the host; a busy
time above either wall time is a measurement fault and raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

SEED = 0


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--requests", type=int, default=5)
    parser.add_argument("--top", type=int, default=15)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA card")

    from .dataset import synthetic_batch
    from .inference import init_random, re10k_encoder_cfg, render_novel_views
    from .model.encoder import EncoderTranSplat

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    encoder = EncoderTranSplat(re10k_encoder_cfg(), device="cuda")
    init_random(encoder, SEED)
    batch = synthetic_batch(SEED, batch_size=1, num_context=2, num_target=4, image_shape=(256, 256))
    dp = encoder.depth_predictor
    stages = {
        "encoder": encoder,
        "encoder.backbone": encoder.backbone,
        "encoder.dav2": encoder.da_model,
        "encoder.depth_predictor": dp,
        "encoder.depth_predictor.uv_matcher": dp.uv_matcher,
        "encoder.depth_predictor.corr_unet": dp.corr_unet,
        "encoder.depth_predictor.refine_unet": dp.refine_unet,
    }
    for name, mod in stages.items():
        mod.register_forward_pre_hook(lambda m, a, n=name: m.__dict__.setdefault("_rf", []).append(record_function(n).__enter__()))
        mod.register_forward_hook(lambda m, a, o: m.__dict__["_rf"].pop().__exit__(None, None, None))
    spans = ("request", *stages)

    def request():
        with record_function("request"):
            return render_novel_views(encoder, batch["context"], batch["target"], (256, 256))

    request()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.requests):
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(times))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            request()
        torch.cuda.synchronize()
        traced_wall_ms = (time.perf_counter() - t0) * 1e3 / args.requests
    events = prof.key_averages()

    def device_ms(e) -> float:
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        return us / 1e3 / args.requests

    is_device = lambda e: getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA  # noqa: E731
    host, span = {}, {}
    for name in spans:
        host[name] = sum(e.cpu_time_total for e in events if e.key == name and not is_device(e)) / 1e3 / args.requests
        span[name] = sum(device_ms(e) for e in events if e.key == name and is_device(e))
        print(json.dumps({"stage": name, "host_ms": host[name], "device_span_ms": span[name]}))
    parts = ("encoder.backbone", "encoder.dav2", "encoder.depth_predictor")
    for name, outer, inner in (
        ("encoder outside its parts (not attributed)", "encoder", parts),
        ("decoder (not attributed)", "request", ("encoder",)),
    ):
        print(json.dumps({
            "stage": name,
            "host_ms": host[outer] - sum(host[n] for n in inner),
            "device_span_ms": span[outer] - sum(span[n] for n in inner),
        }))

    kernels = [e for e in events if is_device(e) and e.key not in spans]
    kernels.sort(key=device_ms, reverse=True)
    for e in kernels[: args.top]:
        print(json.dumps({"kernel": e.key[:120], "calls": e.count // args.requests, "device_ms": device_ms(e)}))
    intervals = [
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if is_device(e) and e.name not in spans
    ]
    if not intervals:
        raise RuntimeError("the trace holds no device events")
    busy_ms = _union_us(intervals) / 1e3 / args.requests
    summed_ms = sum(device_ms(e) for e in kernels)
    if busy_ms > min(wall_ms, traced_wall_ms):
        raise RuntimeError(f"device busy {busy_ms} ms per request exceeds the wall time ({wall_ms}, traced {traced_wall_ms})")
    print(json.dumps({
        "summary": "per request", "requests": args.requests, "wall_ms": wall_ms, "wall_ms_all": times,
        "traced_wall_ms": traced_wall_ms, "device_busy_ms": busy_ms, "device_summed_ms": summed_ms,
        "idle_share": 1.0 - busy_ms / wall_ms, "device": torch.cuda.get_device_name(0),
    }))


if __name__ == "__main__":
    main()
