"""What the readers of the program's own spans and counters share
(transplat_tpu_torch/utils/trace.py): the spans' names, and the card's
idle time a unit put down to a group of spans.

A device op belongs to a span when the runtime call that launched it lies
inside one of the span's intervals (`common.device_ms`). An idle gap, the
time between two of the card's busy intervals, belongs to a span when its
middle lies inside one of the span's intervals, the rule of
`Trace.idle_gaps`. The traced window's host is slowed by the profiler, so
its gaps are longer than the untraced window's: a group's idle time is its
share of the gap time inside the traced units, times the untraced idle time
a unit (`unit_s` less the busy time a unit, as `common.idle_share` takes
it). So the idle times of groups are parts of what `device_idle_share`
reports. A program without the spans gives nothing to read.
"""

from __future__ import annotations

ENCODER_STAGES = (
    "encoder_1_prep_intrinsics", "encoder_2_backbone", "encoder_3_depth_anything", "encoder_4a_prep_features",
    "encoder_4b_cost_volume_matching", "encoder_4c_cost_volume_unet", "encoder_4d_coarse_depth",
    "encoder_4e_depth_refine_unet", "encoder_4f_gaussian_head", "encoder_5_gaussian_adapter",
)
RENDER_STEPS = ("render.project", "render.sort", "render.bin", "render.composite")
SAMPLERS_FORWARD = ("deform.scores", "deform.vectors")
SAMPLERS_BACKWARD = ("deform.scores_bwd", "deform.vectors_bwd")


def _inside(t: float, intervals) -> bool:
    return any(s <= t <= e for s, e in intervals)


def idle_gaps(trace) -> list[tuple[float, float]]:
    """The (start, end) of every gap between the card's busy intervals, in us."""
    merged: list[list[float]] = []
    for s, e in sorted((o.start, o.end) for o in trace.ops):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(a, b) for (_, a), (b, _) in zip(merged, merged[1:])]


def idle_ms(run, spans) -> float | None:
    """The untraced idle time a unit, in ms, times the share of the traced
    units' gap time whose gaps lie (by their middle) inside any of `spans`."""
    intervals = [iv for name in spans for iv in run.trace.spans.get(name, ())]
    if not run.trace.ops or not intervals:
        return None
    units = run.trace.spans.get("unit", ())
    in_units = [(a, b) for a, b in idle_gaps(run.trace) if _inside(0.5 * (a + b), units)]
    total = sum(b - a for a, b in in_units)
    if total <= 0:
        return None
    share = sum(b - a for a, b in in_units if _inside(0.5 * (a + b), intervals)) / total
    idle_s = run.unit_s - run.trace.busy_us() / 1e6 / run.units_traced
    return 1e3 * share * idle_s


def tile_pairs_per_view(run) -> float | None:
    """The program's count of tile-list pairs over its count of views rendered,
    over every render of the process."""
    if not run.trace.ops:
        return None
    try:
        from transplat_tpu_torch.utils.trace import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    views = c.get("render.views", 0)
    return c.get("render.pairs", 0) / views if views else None
