"""The arithmetic the per-layer readers share: each reads a `cellrun.Run`
(the traced window's trace, the units in it, the untraced window's seconds
a unit, the reference's counts) and returns nothing where the trace holds
nothing to read, so that a CPU run reports no device metric."""

from __future__ import annotations

from benchmark.harness.tracing import union_us
from benchmark.metrics.counting import PEAK_F32_FLOPS, least_seconds


def launches(run) -> float | None:
    """Device ops (kernels, copies, fills) launched inside the traced units, a unit."""
    ops = run.trace.launched_in("unit")
    return len(ops) / run.units_traced if ops else None


def idle_share(run) -> float | None:
    """1 - the card's busy time a unit (union of the device ops' intervals) over
    the untraced window's time a unit, in %."""
    if not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / 1e6 / run.units_traced / run.unit_s)


def mfu(run) -> float | None:
    """The reference's FLOPs a unit over the untraced time a unit times the
    float32 peak, in %."""
    flops = run.counts.get("flops_per_unit")
    if not run.trace.ops or not flops:
        return None
    return 100.0 * flops / (run.unit_s * PEAK_F32_FLOPS)


def device_ms(run, *spans: str) -> float | None:
    """Device time of the ops launched inside any of `spans`, a unit, in ms."""
    ops = [o for span in spans for o in run.trace.launched_in(span)]
    if not ops:
        return None
    return union_us([(o.start, o.end) for o in ops]) / 1e3 / run.units_traced


def render_roofline(run) -> float | None:
    """The render's least time (its bytes and operations, `counting.py`) over
    its device time, in %."""
    render_ms, nbytes = device_ms(run, "render"), run.counts.get("render_bytes_per_unit")
    if render_ms is None or not nbytes:
        return None
    return 100.0 * least_seconds(run.counts["render_ops_per_unit"], nbytes) / (render_ms / 1e3)
