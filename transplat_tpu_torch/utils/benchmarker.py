"""Stage-level timer with JSON dumps.

Counterpart of transplat_tpu/utils/benchmarker.py: on the card `time(tag)`
waits for the card (torch.cuda.synchronize) before it starts, so a stage's
time is its own, and reads the device time between two CUDA events recorded
around the stage; on the CPU it reads the host clock. `memory(tag)` records
allocator bytes around a stage. `trace(logdir)` is the counterpart of
`jax.profiler.trace`: a torch.profiler trace (CPU activity, and the card's
when on the card) written into `logdir` as a TensorBoard / Chrome trace. The
JAX package's `compiled_memory_analysis` belongs to XLA's compiler and has no
counterpart here.
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


class Benchmarker:
    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.execution_times: dict[str, list[float]] = defaultdict(list)
        self.memory_stats: dict[str, dict] = {}

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
        record on the CPU, which has no allocator statistics)."""
        if self.device.type != "cuda":
            yield
            self.memory_stats[tag] = {}
            return
        self._sync()
        before = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        try:
            yield
        finally:
            self._sync()
            peak = torch.cuda.max_memory_allocated(self.device)
            self.memory_stats[tag] = {
                "bytes_in_use_before": before,
                "bytes_in_use_after": torch.cuda.memory_allocated(self.device),
                "peak_bytes_in_use": peak,
                "stage_peak_delta": peak - before,
            }

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
