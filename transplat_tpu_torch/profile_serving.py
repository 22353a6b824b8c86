"""Where the time of one full-width serving request goes, on the card.

    python -m transplat_tpu_torch.profile_serving [--requests 5]

Builds the re10k encoder with seeded random weights
(`inference.init_random`), serves one warm-up request (2 context views at
256x256 -> 131,072 Gaussians -> 4 target views at 256x256), times
`--requests` requests without the profiler (host clock, each ending in a
synchronize), then traces as many with torch.profiler. Prints one JSON line
per stage and per top device kernel, and a summary line.

Stages are the program's own spans (utils/trace.py): the encoder's ten
`STAGES`, the deformable samplers inside them, and the render's four steps
(`render.project`, `.sort`, `.bin`, `.composite`), beside this tool's span
around the request. What the request does outside the stages and the
render's steps (the upload of the context, the decoder's reshapes, the
read-back of the colours) is printed as a difference of spans; nothing
inside it is attributed.

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
from torch.profiler import ProfilerActivity, profile

from . import kernels
from .utils.stage_timing import union_us
from .utils.trace import span

SEED = 0
SAMPLER_SPANS = ("deform.scores", "deform.vectors")
RENDER_SPANS = ("render.project", "render.sort", "render.bin", "render.composite")


def report(prof, spans, differences, count: int, top: int, wall_ms: float) -> tuple[float, float]:
    """Print one JSON line per span (host ms and device span ms per
    iteration), per difference of spans (name, outer span, inner spans) and
    per top device kernel of a torch.profiler trace of `count` iterations.
    Returns the device's busy ms (union of the device events' intervals) and
    the plain sum of the device events' ms, per iteration; a busy time above
    `wall_ms` is a measurement fault and raises."""
    events = prof.key_averages()

    def device_ms(e) -> float:
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        return us / 1e3 / count

    is_device = lambda e: getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA  # noqa: E731
    host, span = {}, {}
    for name in spans:
        host[name] = sum(e.cpu_time_total for e in events if e.key == name and not is_device(e)) / 1e3 / count
        span[name] = sum(device_ms(e) for e in events if e.key == name and is_device(e))
        print(json.dumps({"stage": name, "host_ms": host[name], "device_span_ms": span[name]}))
    for name, outer, inner in differences:
        print(json.dumps({
            "stage": name,
            "host_ms": host[outer] - sum(host[n] for n in inner),
            "device_span_ms": span[outer] - sum(span[n] for n in inner),
        }))
    device_ops = [e for e in events if is_device(e) and e.key not in spans]
    device_ops.sort(key=device_ms, reverse=True)
    for e in device_ops[:top]:
        print(json.dumps({"kernel": e.key[:120], "calls": e.count // count, "device_ms": device_ms(e)}))
    intervals = [
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if is_device(e) and e.name not in spans
    ]
    if not intervals:
        raise RuntimeError("the trace holds no device events")
    busy_ms = union_us(intervals) / 1e3 / count
    if busy_ms > wall_ms:
        raise RuntimeError(f"device busy {busy_ms} ms per iteration exceeds the wall time {wall_ms} ms")
    return busy_ms, sum(device_ms(e) for e in device_ops)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--requests", type=int, default=5)
    parser.add_argument("--top", type=int, default=15)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA card")

    from .dataset import synthetic_batch
    from .inference import init_random, re10k_encoder_cfg, render_novel_views
    from .model.encoder import STAGES, EncoderTranSplat

    kernels.strict_float32()
    encoder = EncoderTranSplat(re10k_encoder_cfg(), device="cuda")
    init_random(encoder, SEED)
    batch = synthetic_batch(SEED, batch_size=1, num_context=2, num_target=4, image_shape=(256, 256))
    spans = ("request", *STAGES, *SAMPLER_SPANS, *RENDER_SPANS)

    def request():
        with span("request"):
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
    differences = (("request outside the stages and the render's steps (not attributed)", "request", (*STAGES, *RENDER_SPANS)),)
    busy_ms, summed_ms = report(prof, spans, differences, args.requests, args.top, min(wall_ms, traced_wall_ms))
    print(json.dumps({
        "summary": "per request", "requests": args.requests, "wall_ms": wall_ms, "wall_ms_all": times,
        "traced_wall_ms": traced_wall_ms, "device_busy_ms": busy_ms, "device_summed_ms": summed_ms,
        "idle_share": 1.0 - busy_ms / wall_ms, "device": torch.cuda.get_device_name(0),
    }))


if __name__ == "__main__":
    main()
