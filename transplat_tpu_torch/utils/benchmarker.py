"""Stage-level timer with JSON dumps.

Counterpart of transplat_tpu/utils/benchmarker.py: on the card `time(tag)`
waits for the card (torch.cuda.synchronize) before it starts, so a stage's
time is its own, and reads the device time between two CUDA events recorded
around the stage; on the CPU it reads the host clock. `memory(tag)` records
allocator bytes around a stage; `dump_memory(path)` writes them with the
allocator's totals (`device_memory_stats`) as JAX's peak_memory.json.
`time_blocking(tag)` reads the host clock up to the card's completion: with
`time(tag)` around the same block, the difference is the time before the
card starts the block's first kernel and after it ends its last
(utils/stage_timing.py reads the gaps between with torch.profiler).
`trace(logdir)` is the counterpart of `jax.profiler.trace`: a torch.profiler
trace (CPU activity, and the card's when on the card) written into `logdir`
as a TensorBoard / Chrome trace. The JAX package's
`compiled_memory_analysis` belongs to XLA's compiler and has no counterpart
here.

Peaks: JAX's `peak_bytes_in_use` is the allocator's high-water mark over the
process's life. PyTorch's is reset by `torch.cuda.reset_peak_memory_stats`,
which `memory(tag)` calls to read each stage's own peak; so a Benchmarker
keeps the highest peak it saw before each of its resets, and its dump's
`device` record gives the larger of that and the allocator's peak since.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch

STAGE_ORDER = [
    "encoder_1_prep_intrinsics",
    "encoder_2_backbone",
    "encoder_3_depth_anything",
    "encoder_4_depth_predictor",
    "encoder_4a_prep_features",
    "encoder_4b_cost_volume_matching",
    "encoder_4c_cost_volume_unet",
    "encoder_4d_coarse_depth",
    "encoder_4e_depth_refine_unet",
    "encoder_4f_gaussian_head",
    "encoder_5_gaussian_adapter",
    "encoder",
    "decoder",
]


def device_memory_stats(device: str | torch.device | None = None) -> dict:
    """The allocator's statistics for one card (`torch.cuda.memory_stats`,
    every key), with JAX's names beside them: `bytes_in_use`,
    `peak_bytes_in_use` (since the last reset of the peak), `bytes_reserved`
    and `bytes_limit` (the card's memory). {} on the CPU, as JAX's on
    backends without allocator statistics."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = dict(torch.cuda.memory_stats(device))
    return {
        **stats,
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


class Benchmarker:
    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.execution_times: dict[str, list[float]] = defaultdict(list)
        self.memory_stats: dict[str, dict] = {}
        self.lifetime_peak = 0  # the highest allocator peak seen before a reset of this Benchmarker's

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def time(self, tag: str, num_calls: int = 1):
        """Seconds of the stage inside, split evenly over `num_calls`: device
        time between CUDA events on the card, the host clock on the CPU."""
        self._sync()
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                end.record()
                end.synchronize()
                elapsed = start.elapsed_time(end) / 1e3
            else:
                elapsed = time.perf_counter() - t0
            for _ in range(num_calls):
                self.execution_times[tag].append(elapsed / num_calls)

    @contextmanager
    def time_blocking(self, tag: str):
        """Host seconds of the block up to the card's completion of it: the
        card is synchronized before and after (JAX's blocks on the yielded
        dict's "result"; here every stream's work is waited for, so the dict
        is only kept for JAX's calling convention)."""
        self._sync()
        start = time.perf_counter()
        out: dict = {}
        try:
            yield out
        finally:
            self._sync()
            self.execution_times[tag].append(time.perf_counter() - start)

    @contextmanager
    def trace(self, logdir: str | Path):
        """Profile the block into `logdir` (`<host>_<pid>.<time>.pt.trace.json`,
        readable by TensorBoard's profiler plugin and chrome://tracing);
        yields the profiler, whose `key_averages()` tabulates the ops."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
            yield prof

    @contextmanager
    def memory(self, tag: str):
        """Bytes allocated before and after a stage and its peak (an empty
        record on the CPU, which has no allocator statistics).

        `peak_bytes_in_use` is the stage's own peak (the allocator's peak is
        reset before it) and `stage_peak_delta` its rise over the bytes in
        use before; JAX's keys stand beside them: `stage_peak_delta_est`
        (the same number: here it is measured, not estimated) and
        `peak_bytes_in_use_cumulative`, the highest peak this Benchmarker has
        seen up to the stage's end."""
        if self.device.type != "cuda":
            yield
            self.memory_stats[tag] = {}
            return
        self._sync()
        before = torch.cuda.memory_allocated(self.device)
        self.lifetime_peak = max(self.lifetime_peak, torch.cuda.max_memory_allocated(self.device))
        torch.cuda.reset_peak_memory_stats(self.device)
        try:
            yield
        finally:
            self._sync()
            peak = torch.cuda.max_memory_allocated(self.device)
            self.lifetime_peak = max(self.lifetime_peak, peak)
            self.memory_stats[tag] = {
                "bytes_in_use_before": before,
                "bytes_in_use_after": torch.cuda.memory_allocated(self.device),
                "peak_bytes_in_use": peak,
                "stage_peak_delta": peak - before,
                "peak_bytes_in_use_cumulative": self.lifetime_peak,
                "stage_peak_delta_est": peak - before,
            }

    def dump_memory(self, path: str | Path, extra: dict | None = None) -> None:
        """peak_memory.json: {"device": the allocator's totals, "stages": the
        per-stage records, **extra}. The device record's `peak_bytes_in_use`
        is the highest peak over this Benchmarker's life (see the module's
        docstring), so it is at least every stage's peak; {} on the CPU."""
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        device = device_memory_stats(self.device)
        if device:
            device["peak_bytes_in_use"] = max(device["peak_bytes_in_use"], self.lifetime_peak)
        record = {"device": device, "stages": self.memory_stats}
        if extra:
            record.update(extra)
        with open(path, "w") as f:
            json.dump(record, f, indent=2)

    def summarize(self, skip_first: int = 0) -> dict:
        out = {}
        for tag, times in self.execution_times.items():
            used = times[skip_first:] if len(times) > skip_first else times
            out[tag] = {
                "count": len(used),
                "total_s": sum(used),
                "mean_ms": 1e3 * sum(used) / max(len(used), 1),
            }
        return out

    def dump(self, path: str | Path, skip_first: int = 0) -> None:
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        with open(path, "w") as f:
            json.dump({"summary": self.summarize(skip_first), "raw": dict(self.execution_times)}, f, indent=2)

    def print_table(self, skip_first: int = 0) -> None:
        summary = self.summarize(skip_first)
        ordered = [t for t in STAGE_ORDER if t in summary]
        ordered += [t for t in summary if t not in ordered]
        print(f"{'stage':<36}{'count':>8}{'mean ms':>12}{'total s':>12}")
        for tag in ordered:
            s = summary[tag]
            print(f"{tag:<36}{s['count']:>8}{s['mean_ms']:>12.2f}{s['total_s']:>12.3f}")

    def clear_history(self) -> None:
        self.execution_times.clear()
