"""The readers of the program's own spans and counters
(`metrics/program_spans.py`) on a hand-built trace, their numbers reckoned
by hand; and nothing from them where the trace holds no device op or the
program opened none of their spans."""

from __future__ import annotations

import pytest

from benchmark.harness import cellrun, spec, tracing

NEW = ["backbone_device_ms.serve", "dav2_device_ms.serve", "matcher_device_ms.serve", "unet_device_ms.serve",
       "deform_device_ms.serve", "deform_device_ms.train", "encoder_idle_ms.serve", "render_idle_ms.serve",
       "tile_pairs_per_view.serve"]

# (span, its start in the unit, the duration of the one kernel launched in it);
# each span 1000 us long, its kernel launched 2 us into it and run from 30 us
# into it; deform.scores lies inside encoder_4b and launches 4b's kernel.
SPANS = [("encoder_2_backbone", 100, 1000.0), ("encoder_3_depth_anything", 1200, 400.0),
         ("encoder_4b_cost_volume_matching", 2300, 300.0), ("encoder_4c_cost_volume_unet", 3400, 200.0),
         ("encoder_4e_depth_refine_unet", 4500, 100.0), ("render.bin", 5600, 50.0),
         ("deform.vectors_bwd", 6700, 20.0)]


def _trace(spans=SPANS) -> tracing.Trace:
    """Two units of 10 ms, each with the kernels of SPANS."""
    events, corr = [], 0
    for u in range(2):
        t = u * 10_000.0
        events.append({"ph": "X", "cat": "user_annotation", "name": "unit", "ts": t, "dur": 10_000.0})
        for name, start, dur in spans:
            events.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": t + start, "dur": 1000.0})
            if name == "encoder_4b_cost_volume_matching":
                events.append({"ph": "X", "cat": "user_annotation", "name": "deform.scores", "ts": t + start + 1,
                               "dur": 500.0})
            corr += 1
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t + start + 2,
                           "dur": 1, "args": {"correlation": corr}})
            events.append({"ph": "X", "cat": "kernel", "name": f"{name}_k", "ts": t + start + 30, "dur": dur,
                           "args": {"correlation": corr}})
    return tracing.parse_chrome_trace(events)


@pytest.fixture
def run():
    return cellrun.Run(trace=_trace(), units_traced=2, unit_s=0.010)


def _read(name, run):
    return spec.reader(name)(run)


def test_device_time_of_each_group_of_spans(run):
    assert _read("backbone_device_ms.serve", run) == pytest.approx(1.0)
    assert _read("dav2_device_ms.serve", run) == pytest.approx(0.4)
    assert _read("matcher_device_ms.serve", run) == pytest.approx(0.3)  # 4a is absent, 4b's kernel
    assert _read("unet_device_ms.serve", run) == pytest.approx(0.2 + 0.1)
    assert _read("deform_device_ms.serve", run) == pytest.approx(0.3)  # the kernel launched in deform.scores
    assert _read("deform_device_ms.train", run) == pytest.approx(0.3 + 0.02)


def test_idle_time_put_down_to_the_stages_and_the_render_scaled_to_the_untraced_unit(run):
    # A unit's kernels run at (span start + 30) for their durations. The gaps,
    # with their middles: backbone -> DAv2 (1130, 1230), 1180, in no span;
    # DAv2 -> 4b (1630, 2330), 1980, in DAv2; 4b -> 4c 800, in 4b; 4c -> 4e
    # 900, in 4c; 4e -> render.bin 1000, in 4e; render.bin -> the backward
    # (5680, 6730), 6205, in render.bin; the backward -> the second unit's
    # backbone (6750, 10130), 8440, in the first unit and in no span.
    encoder, render = 2 * (700 + 800 + 900 + 1000), 2 * 1050
    in_units = encoder + render + 2 * 100 + 3380
    # Busy 1000 + 400 + 300 + 200 + 100 + 50 + 20 us a unit of 10 ms untraced.
    idle_ms = 10.0 - 2.07
    assert _read("encoder_idle_ms.serve", run) == pytest.approx(idle_ms * encoder / in_units)
    assert _read("render_idle_ms.serve", run) == pytest.approx(idle_ms * render / in_units)
    assert _read("encoder_idle_ms.serve", run) + _read("render_idle_ms.serve", run) < idle_ms
    assert _read("device_idle_share.serve", run) == pytest.approx(100 * idle_ms / 10.0)


def test_tile_pairs_a_view_over_every_render_of_the_process(run):
    from transplat_tpu_torch.utils import trace

    trace.reset_counters()
    assert _read("tile_pairs_per_view.serve", run) is None  # nothing rendered
    trace.count("render.pairs", 600)
    trace.count("render.views", 2)
    trace.count("render.pairs", 300)
    trace.count("render.views", 1)
    assert _read("tile_pairs_per_view.serve", run) == pytest.approx(300.0)
    trace.reset_counters()


@pytest.mark.parametrize("name", NEW)
def test_nothing_without_device_ops(run, name):
    from transplat_tpu_torch.utils import trace

    trace.count("render.pairs", 10)
    trace.count("render.views", 1)
    run.trace = tracing.Trace()
    assert _read(name, run) is None
    trace.reset_counters()


@pytest.mark.parametrize("name", [n for n in NEW if n != "tile_pairs_per_view.serve"])
def test_nothing_from_a_program_without_the_spans(name):
    """A program that opens none of these spans: device ops under the
    harness's own spans alone give nothing to read."""
    run = cellrun.Run(trace=_trace([("encoder", 100, 1000.0), ("render", 5600, 50.0)]), units_traced=2, unit_s=0.010)
    assert _read(name, run) is None


def test_every_new_metric_is_declared_with_its_cells():
    bench = spec.load_spec()
    declared = {m["name"]: m for m in bench["per_layer"]}
    assert set(NEW) <= set(declared)
    assert declared["deform_device_ms.train"]["workloads"] == ["re10k-train"]
    assert declared["render_idle_ms.serve"]["workloads"] == ["re10k-serve", "dtu-nctx3-serve", "re10k-view"]
