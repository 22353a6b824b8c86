"""The metric arithmetic on synthetic timings and a synthetic trace."""

from __future__ import annotations

import pytest

from benchmark.harness import cellrun, spec, tracing
from benchmark.harness import driver
from benchmark.harness.serving import Serving
from benchmark.metrics import counting


def _trace() -> tracing.Trace:
    """Two units of 10 ms; in each, an encoder span launching two 1 ms
    kernels and a render span launching one 0.5 ms kernel, all launched
    2 us into their span and run back to back on the device."""
    events = []
    corr = 0
    for u in range(2):
        t = u * 10_000.0
        events.append({"ph": "X", "cat": "user_annotation", "name": "unit", "ts": t, "dur": 10_000.0})
        for span, start, kernels in (("encoder", t + 100, [1000.0, 1000.0]), ("render", t + 5000, [500.0])):
            events.append({"ph": "X", "cat": "user_annotation", "name": span, "ts": start, "dur": 3000.0})
            dev = start + 50
            for k, dur in enumerate(kernels):
                corr += 1
                launch = start + 2 + k
                events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch, "dur": 1,
                               "args": {"correlation": corr}})
                events.append({"ph": "X", "cat": "kernel", "name": f"{span}_k{k}", "ts": dev, "dur": dur,
                               "args": {"correlation": corr}})
                dev += dur
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 2900.0, "dur": 2000.0})
    events.append({"ph": "f", "cat": "ac2g", "name": "flow", "ts": 0})
    return tracing.parse_chrome_trace(events)


def test_union_of_intervals():
    assert tracing.union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert tracing.union_us([]) == 0


def test_trace_attribution():
    tr = _trace()
    assert len(tr.ops) == 6 and tr.busy_us() == 2 * 2500.0
    assert [o.name for o in tr.launched_in("encoder")] == ["encoder_k0", "encoder_k1"] * 2
    assert len(tr.launched_in("unit")) == 6
    assert tr.top_ops(2) == [["encoder_k0", 0.002], ["encoder_k1", 0.002]]
    gaps = dict(tr.idle_gaps())
    # The gap between the first unit's encoder and render kernels (2150 us to
    # 5050 us) has its middle inside aten::copy_, the innermost op there.
    assert gaps["aten::copy_"] == pytest.approx(2900 / 1e6)


@pytest.fixture
def run():
    return cellrun.Run(trace=_trace(), units_traced=2, unit_s=0.010,
                       counts={"flops_per_unit": 67e12 * 0.001, "render_ops_per_unit": 0.0,
                               "render_bytes_per_unit": 3.35e12 * 0.0001})


def _read(name, run):
    return spec.reader(name)(run)


def test_readers_on_the_synthetic_trace(run):
    assert _read("launches_per_request.serve", run) == 3
    assert _read("encoder_device_ms.serve", run) == pytest.approx(2.0)
    assert _read("render_device_ms.serve", run) == pytest.approx(0.5)
    assert _read("device_idle_share.serve", run) == pytest.approx(75.0)  # 2.5 ms busy of 10
    assert _read("mfu.serve", run) == pytest.approx(10.0)  # 1 ms of the peak's work in 10 ms
    assert _read("rasterizer_roofline.serve", run) == pytest.approx(20.0)  # 0.1 ms least of 0.5 ms


def test_readers_find_nothing_without_device_ops(run):
    run.trace = tracing.Trace()
    for m in spec.load_spec()["per_layer"]:
        assert _read(m["name"], run) is None, m["name"]


def test_window_rate_and_tail_over_all_requests():
    latencies = [0.1] * 95 + [0.2] * 5
    e2e = Serving.end_to_end(None, latencies, 12.5, 0)
    assert e2e["requests_per_s"] == 8.0
    assert e2e["request_ms_p95"] == pytest.approx(105.0)  # numpy's linear quantile over all 100


def test_window_keeps_a_seeded_uniform_sample():
    import random

    class Fake:
        def run_unit(self, i, keep):
            return {"index": i} if keep else None

    latencies, window_s, sample = driver.closed_loop(Fake(), 0.05, 3, 7)
    assert window_s >= 0.05 and len(latencies) > 3
    # Reservoir sampling, replayed from the same seed over the same count.
    rng = random.Random(driver.stream_seed(7, driver.STREAM_SAMPLE))
    slots = list(range(3))
    for i in range(3, len(latencies)):
        j = rng.randrange(i + 1)
        if j < 3:
            slots[j] = i
    assert [s["index"] for s in sample] == slots


def test_least_time_and_render_bytes():
    assert counting.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert counting.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    # 2 Gaussians with 4 harmonics per channel, 3 views of 2 x 2 pixels:
    # 3 x (2 x (3 + 9 + 12 + 1) + 4 x 3) floats.
    assert counting.render_bytes(2, 4, 3, (2, 2)) == 4 * 3 * (2 * 25 + 12)
