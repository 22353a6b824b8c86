"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference, and the result line.

The driver of the cell's kind of traffic (`kinds/<kind>.py`) measures the
window; the default is a closed loop with one client (`driver.py`). A
sample of the window's units, drawn from the seed, keeps its outputs for
the comparison, which runs after the window has closed, the memory peak
has been read and the program's state is freed. `--trace 1` adds, after
the window, a few units under torch.profiler with the benchmark's spans,
and prints the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field

import torch

from . import kinds, serving, tracing
from .spec import Cell, reader

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "transplat_tpu")


@dataclass
class Run:
    """What the per-layer readers read: the traced window's trace, how many
    units it holds, the mean seconds of a unit in the untraced window, and
    the reference's counts of a unit's work."""

    trace: tracing.Trace
    units_traced: int
    unit_s: float
    counts: dict = field(default_factory=dict)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN})


def _metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def device_info(device: torch.device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float) -> dict:
    """Run `cell` once and return the result line's object; `t_start` is the
    host time the process began its set-up."""
    traffic = cell.traffic
    if cell.config["precision"] == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    driver = kinds.find(traffic["kind"])(cell, seed, device)
    driver.warm()
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    latencies, window_s, samples = driver.window(seconds, traffic["check"].get("sample", 0), seed)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    completed = len(latencies)

    run = None
    if trace:
        units = traffic["trace"]["units"]
        traced_units: list[dict] = []

        bounds: list[float] = []

        def traced_window():
            with driver.spans():
                bounds.append(time.perf_counter())
                for j in range(units):
                    with tracing.record_function("unit"):
                        traced_units.append(driver.run_unit(completed + j, keep=True))
                serving.sync(device)
                bounds.append(time.perf_counter())

        run = Run(tracing.traced(traced_window, device), units, window_s / completed)
        traced_s = bounds[1] - bounds[0]

    driver.release()
    numbers = driver.compare(samples)
    limits = traffic["check"]["limits"]
    checked = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checked.values())

    info = device_info(device, peak)
    if trace:
        run.counts = driver.counts(traced_units)
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = _metric(value, m["unit"])
        busy_s = run.trace.busy_us() / 1e6
        info.update(busy_s=busy_s, window_s=traced_s)
        breakdown = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    else:
        e2e = {**driver.end_to_end(latencies, window_s, peak), "setup_s": setup_s}
        metrics = {m["name"]: _metric(e2e[m["name"]], m["unit"]) for m in cell.end_to_end}
    result = {"correct": correct, "attempted": completed, "failed": 0, "metrics": metrics, "device": info}
    if trace:
        result["breakdown"] = breakdown
    result["checked"] = checked
    return result
