"""The traced window: spans the benchmark opens itself, a torch.profiler
trace of a few units, and its reduction to device time and launches.

Spans are `record_function` ranges opened by the harness around each unit
("unit") and, through forward hooks, around program modules (the serving
drivers' "encoder"). The trace is exported as Chrome trace JSON (Kineto's
format: device ops of category kernel, gpu_memcpy and gpu_memset, each
carrying the correlation id of the runtime call that launched it) into
TMPDIR, read back and deleted. A device op belongs to a span when the
runtime call that launched it lies inside the span on the host.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import tempfile
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals (frozen from the port's
    utils/stage_timing.py `union_us`)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


@dataclass
class DeviceOp:
    name: str
    start: float  # us
    end: float
    launch: float | None  # host time of the launching runtime call (us), if known


@dataclass
class Trace:
    """A parsed trace: device ops, the benchmark's spans and the host ops."""

    ops: list[DeviceOp] = field(default_factory=list)
    spans: dict[str, list[tuple[float, float]]] = field(default_factory=dict)
    host: list[tuple[float, float, str]] = field(default_factory=list)

    def busy_us(self) -> float:
        return union_us([(o.start, o.end) for o in self.ops])

    def launched_in(self, span: str) -> list[DeviceOp]:
        """Device ops launched inside an interval of `span`."""
        intervals = self.spans.get(span, ())
        return [o for o in self.ops if o.launch is not None and any(s <= o.launch <= e for s, e in intervals)]

    def top_ops(self, n: int = 10) -> list[list]:
        """The device ops that took most time, by name: [[name, seconds], ...]."""
        total: dict[str, float] = {}
        for o in self.ops:
            total[o.name] = total.get(o.name, 0.0) + (o.end - o.start) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The device's idle time between ops, summed by the innermost host
        op running at each gap's middle: [[host op, seconds], ...]."""
        merged: list[list[float]] = []
        for s, e in sorted((o.start, o.end) for o in self.ops):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        host = sorted(self.host)
        active: list[tuple[float, float, str]] = []  # heap of (end, duration, name)
        j = 0
        total: dict[str, float] = {}
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = 0.5 * (a + b)
            while j < len(host) and host[j][0] <= mid:
                s, e, name = host[j]
                heapq.heappush(active, (e, e - s, name))
                j += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            label = min((d, name) for _, d, name in active)[1] if active else "(no host op)"
            total[label] = total.get(label, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def parse_chrome_trace(events: list[dict]) -> Trace:
    trace = Trace()
    launches: dict[int, float] = {}
    device: list[tuple[str, float, float, int | None]] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((ev.get("name", "?"), ts, ts + dur, corr))
        elif cat in HOST_CATS:
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = ts
            if cat == "user_annotation":
                trace.spans.setdefault(ev.get("name", "?"), []).append((ts, ts + dur))
            trace.host.append((ts, ts + dur, ev.get("name", "?")))
    trace.ops = [DeviceOp(name, s, e, launches.get(corr)) for name, s, e, corr in device]
    return trace


@contextlib.contextmanager
def module_span(module: torch.nn.Module, name: str):
    """A span named `name` around every forward of `module` while inside."""
    stack = []
    pre = module.register_forward_pre_hook(lambda m, a: stack.append(record_function(name).__enter__()))
    post = module.register_forward_hook(lambda m, a, o: stack.pop().__exit__(None, None, None))
    try:
        yield
    finally:
        pre.remove()
        post.remove()


def traced(fn, device: torch.device) -> Trace:
    """Run `fn()` under torch.profiler (host and, on a card, device
    activity) and return its parsed trace."""
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return parse_chrome_trace(data["traceEvents"] if isinstance(data, dict) else data)

