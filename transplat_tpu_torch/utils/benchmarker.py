"""Stage-level wall-clock timer with JSON dumps.

Counterpart of transplat_tpu/utils/benchmarker.py: `time(tag)` waits for the
card (torch.cuda.synchronize) before it starts and before it stops the
clock, so a stage's time is its own; `memory(tag)` records allocator bytes
around a stage. The JAX package's `trace` and `compiled_memory_analysis`
belong to XLA's profiler and compiler and have no counterpart here
(profile_serving.py and profile_training.py trace with torch.profiler).
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
        self._sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            elapsed = time.perf_counter() - start
            for _ in range(num_calls):
                self.execution_times[tag].append(elapsed / num_calls)

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
