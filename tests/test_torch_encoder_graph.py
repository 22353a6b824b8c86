"""The TranSplat encoder's CUDA-graph route on the CPU: which forwards take
it (model/encoder.py `graph_route`), the cache and replay machinery that
needs no card (utils/graphs.py, utils/trace.py), and the capture-safe
rewrites of the forward's path, held to the per-call code they replace.
The captures and replays themselves run on the card (tests/test_torch_cuda.py).
"""

import copy

import numpy as np
import pytest
import torch

from transplat_tpu_torch import kernels
from transplat_tpu_torch.dataset import synthetic_batch
from transplat_tpu_torch.geometry.epipolar import epipolar_sample_grid, inverse_depth_candidates, relative_pose
from transplat_tpu_torch.geometry.projection import unnormalize_intrinsics
from transplat_tpu_torch.inference import init_random
from transplat_tpu_torch.model.backbone.multiview import IMAGENET_MEAN, IMAGENET_STD, normalize_images
from transplat_tpu_torch.model.backbone.position import add_position_windowed, position_embedding_sine
from transplat_tpu_torch.model.depth_predictor import img2world_matrices
from transplat_tpu_torch.model.encoder import EncoderTranSplat
from transplat_tpu_torch.ops import interpolate, window
from transplat_tpu_torch.train_demo import tiny_encoder_cfg
from transplat_tpu_torch.utils import graphs, trace
from transplat_tpu_torch.utils.constants import device_array, device_constant

KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


@pytest.fixture(scope="module")
def encoder():
    enc = EncoderTranSplat(tiny_encoder_cfg(), device="cpu")
    init_random(enc, 0)
    return enc


@pytest.fixture(scope="module")
def ctx():
    batch = synthetic_batch(0, batch_size=1, num_context=2, num_target=1, image_shape=(64, 64))
    return [torch.as_tensor(batch["context"][k]) for k in KEYS]


class _Recorder:
    """Stands in for the encoder's GraphCache: records the calls that took
    the graph route and runs them eagerly."""

    def __init__(self):
        self.keys = []

    def __call__(self, key, fn, inputs):
        self.keys.append(key)
        return fn(*inputs)

    def clear(self):
        pass


# --- which forwards take the graph route


def test_a_cpu_forward_runs_eagerly_and_counts_so(encoder, ctx):
    trace.reset_counters()
    with torch.no_grad():
        encoder(*ctx)
    assert not encoder.graph_route(ctx)
    assert trace.counters()["encoder.graph.eager"] == 1 and "encoder.graph.replay" not in trace.counters()
    assert len(encoder._graphs) == 0


def _on_card_route(*tensors):
    """kernels.kernel_route with CPU tensors standing in for the card's."""
    given = [t for t in tensors if t is not None]
    return all(t.dtype == torch.float32 for t in given) and not (
        torch.is_grad_enabled() and any(t.requires_grad for t in given))


@pytest.mark.parametrize("case", ["route", "training", "grad", "input_grad", "float64"])
def test_the_route_rule(encoder, ctx, monkeypatch, case):
    """Eval mode, float32 inputs on the card, no gradient recorded: each
    condition broken alone gives the eager route (the card's check of the
    inputs played by CPU tensors)."""
    monkeypatch.setattr(kernels, "kernel_route", _on_card_route)
    inputs = list(ctx)
    if case == "input_grad":
        inputs[0] = inputs[0].clone().requires_grad_()
    if case == "float64":
        inputs[1] = inputs[1].double()
    try:
        if case == "training":
            encoder.train()
        with torch.set_grad_enabled(case in ("grad", "input_grad")):
            assert encoder.graph_route(inputs) == (case == "route")
    finally:
        encoder.eval()


@pytest.mark.parametrize("case", ["route", "stage", "generator"])
def test_a_stage_or_generator_runs_eagerly(encoder, ctx, monkeypatch, case):
    """Where the rule holds the forward goes to the graphs with its
    signature; a `stage` context or a `generator` keeps it eager, counted as
    encoder.graph.eager."""
    monkeypatch.setattr(encoder, "graph_route", lambda inputs: True)
    recorder = _Recorder()
    monkeypatch.setattr(encoder, "_graphs", recorder)
    kwargs = {"stage": lambda tag: torch.no_grad()} if case == "stage" else {}
    if case == "generator":
        kwargs["generator"] = torch.Generator().manual_seed(0)
    trace.reset_counters()
    with torch.no_grad():
        encoder(*ctx, **kwargs)
    if case == "route":
        assert len(recorder.keys) == 1 and "encoder.graph.eager" not in trace.counters()
        shapes, aux, exponent, device = recorder.keys[0][:4]
        assert shapes == tuple(tuple(x.shape) for x in ctx) and aux is False and device == ctx[0].device
        assert exponent == 2.0 ** tiny_encoder_cfg().opacity_mapping.initial
    else:
        assert recorder.keys == [] and trace.counters()["encoder.graph.eager"] == 1


def test_a_running_profiler_captures_nothing():
    """A signature met first while a profiler runs runs eagerly, counted as
    eager, and leaves no graph (a capture never starts under the profiler)."""
    cache = graphs.GraphCache("probe")
    x = torch.arange(4.0)
    trace.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = cache(("k",), lambda t: t * 2, (x,))
    assert torch.equal(out, x * 2) and len(cache) == 0
    assert trace.counters() == {"probe.eager": 1}


# --- the cache, the replay and the counts, without a card


class _FakeGraph:
    """A captured segment's stand-in: its replay runs `fn`."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _plan(counts=None, launches=None):
    static_in = torch.zeros(3)
    static_out = torch.zeros(3)
    steps = [
        _FakeGraph(lambda: None),
        ("encoder_1_prep_intrinsics", True),
        _FakeGraph(lambda: static_out.copy_(static_in * 2)),
        ("encoder_1_prep_intrinsics", False),
    ]
    return graphs._Plan([static_in], steps, {"y": static_out}, counts or {}, launches or {})


def test_a_replay_copies_inputs_in_and_outputs_out():
    plan = _plan()
    first = plan.replay([torch.tensor([1.0, 2.0, 3.0])])
    second = plan.replay([torch.tensor([5.0, 6.0, 7.0])])
    assert torch.equal(first["y"], torch.tensor([2.0, 4.0, 6.0])), "a later replay overwrote a returned output"
    assert torch.equal(second["y"], torch.tensor([10.0, 12.0, 14.0]))
    assert first["y"].data_ptr() != plan.output["y"].data_ptr()


def test_a_replay_adds_the_captured_counts_again():
    plan = _plan({"adapter.fused": 1}, {"gaussian_adapter": 1, "deform_vectors": 2})
    trace.reset_counters()
    kernels.reset_launches()
    for _ in range(3):
        plan.replay([torch.ones(3)])
    assert trace.counters() == {"adapter.fused": 3}
    assert kernels.launches == {"gaussian_adapter": 3, "deform_vectors": 6}


def test_a_replay_opens_the_captured_spans_under_a_profiler():
    plan = _plan()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        plan.replay([torch.ones(3)])
    names = [e.name for e in prof.events()]
    assert names.count("encoder_1_prep_intrinsics") == 1


def test_the_cache_replays_keeps_a_handful_and_drops_the_oldest(monkeypatch):
    captured = []

    def fake_capture(fn, inputs, stream):
        captured.append(inputs[0].item())
        return fn(*inputs), _plan()

    monkeypatch.setattr(graphs, "capture", fake_capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    cache = graphs.GraphCache("probe", capacity=2)
    trace.reset_counters()
    for k in (1, 2, 1, 3, 2):  # 3 drops 2 (1 was used since); 2 is captured again
        cache((k,), lambda t: t, (torch.tensor(float(k)),))
    assert captured == [1.0, 2.0, 3.0, 2.0] and list(cache._plans) == [(3,), (2,)]
    assert trace.counters() == {"probe.eager": 4, "probe.captures": 4, "probe.replay": 1}
    assert len(copy.deepcopy(cache)) == 0 and len(cache) == 2
    cache.clear()
    assert len(cache) == 0


def test_moves_casts_and_train_drop_the_graphs(encoder):
    """`.to()` and casts (`_apply`) and `train()` drop every graph; `eval()`
    keeps them."""
    for drop in (lambda e: e.to("cpu"), lambda e: e.float(), lambda e: e.train()):
        encoder._graphs._plans["k"] = _plan()
        encoder.eval()
        assert len(encoder._graphs) == 1
        drop(encoder)
        assert len(encoder._graphs) == 0
    encoder.eval()
    assert len(copy.deepcopy(encoder)._graphs) == 0


def test_spans_cut_the_capture_where_they_open_and_close():
    cuts = []
    with trace.cut_at_spans(lambda name, opens: cuts.append((name, opens))):
        with trace.span("a"):
            with trace.span("b"):
                pass
        with pytest.raises(ValueError), trace.span("c"):
            raise ValueError
    assert cuts == [("a", True), ("b", True), ("b", False), ("a", False), ("c", True)]
    assert trace.span("a") is trace._OFF  # outside, a plain span again


def test_withheld_counts_leave_the_counters_as_they_were():
    trace.reset_counters()
    trace.count("x", 2)
    into = {}
    with trace.withheld(into):
        trace.count("x", 1)
        trace.count("y", 4)
    assert into == {"x": 1, "y": 4} and trace.counters() == {"x": 2}
    launches, into = {"deform_vectors": 1}, {}
    with trace.withheld(into, launches):
        launches["deform_vectors"] += 2
        launches["gaussian_adapter"] = 1
    assert into == {"deform_vectors": 2, "gaussian_adapter": 1} and launches == {"deform_vectors": 1}


# --- the capture-safe rewrites give the values the per-call code gave


def _cameras(views=3, seed=0):
    batch = synthetic_batch(seed, batch_size=2, num_context=views, num_target=1, image_shape=(64, 64))
    return [torch.as_tensor(batch["context"][k]) for k in ("intrinsics", "extrinsics", "near", "far")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_inv_ex_equals_inv_on_the_encoders_matrices(dtype):
    """The encoder's three inverses (stage 1's and 4a's [[K, 0], [0, 1]], the
    target extrinsics of relative_pose, the pixel intrinsics of the epipolar
    grid), as inv_ex, equal inv's bit for bit, and the functions that take
    them equal their inv versions."""
    intr, extr, near, far = (t.to(dtype) for t in _cameras())
    for shape in ((64, 64), (16, 16)):
        intr_px = unnormalize_intrinsics(intr, shape)
        camk = torch.eye(4, dtype=dtype).expand(*extr.shape[:-2], 4, 4).clone()
        camk[..., :3, :3] = intr_px
        for m in (camk, extr, intr_px):
            assert torch.equal(torch.linalg.inv_ex(m).inverse, torch.linalg.inv(m))
        assert torch.equal(img2world_matrices(intr_px, extr), torch.matmul(extr, torch.linalg.inv(camk)))
        rel = relative_pose(extr[:, 0], extr[:, 1])
        assert torch.equal(rel, torch.matmul(torch.linalg.inv(extr[:, 1]), extr[:, 0]))
        h, w = shape
        depths = 1.0 / inverse_depth_candidates(near, far, 8)[:, 0]
        grid = epipolar_sample_grid(intr_px[:, 0], rel, depths, h, w)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype), torch.arange(w, dtype=dtype), indexing="ij")
        pix = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones(h * w, dtype=dtype)])
        rays = rel[..., :3, :3] @ (torch.linalg.inv(intr_px[:, 0]) @ pix)
        pts = rays[..., :, None, :] * depths[..., None, :, None] + rel[..., :3, 3:4][..., None, :]
        pts = torch.einsum("...ij,...jdn->...idn", intr_px[:, 0], pts)
        xy = pts[..., :2, :, :] / torch.clamp(pts[..., 2:3, :, :], min=1e-3)
        ref = torch.stack([xy[..., 0, :, :] / (w - 1), xy[..., 1, :, :] / (h - 1)], dim=-1)
        assert torch.equal(grid, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_device_constants_equal_the_per_call_tensors(dtype):
    like = torch.zeros(2, dtype=dtype)
    for values in ((64, 32), IMAGENET_MEAN, IMAGENET_STD, ((256,), (128,), (1.0,))):
        got = device_constant(values, like)
        assert torch.equal(got, torch.tensor(values, dtype=dtype)) and got.dtype == dtype
        assert device_constant(values, like) is got  # made once
    assert torch.equal(device_constant((2, 0, 1), like, torch.int64), torch.tensor([2, 0, 1]))
    assert device_array(interpolate._resize_weights, 5, 9, True, device="cpu", dtype=dtype) is device_array(
        interpolate._resize_weights, 5, 9, True, device="cpu", dtype=dtype)


def test_the_constant_rewrites_give_the_values_of_the_per_call_code():
    """normalize_images, unnormalize_intrinsics, the interpolation matrices,
    the windowed positions and the shifted-window mask and key order, each
    against the per-call version it replaced."""
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(1, 2, 8, 8, 3, generator=gen)
    mean, std = torch.tensor(IMAGENET_MEAN), torch.tensor(IMAGENET_STD)
    assert torch.equal(normalize_images(images), (images - mean) / std)
    intr = _cameras()[0]
    assert torch.equal(unnormalize_intrinsics(intr, (48, 64)), intr * torch.tensor([[64.0], [48.0], [1.0]]))

    x = torch.rand(2, 3, 7, 5, generator=gen)
    for align in (True, False):
        wh = torch.from_numpy(interpolate._resize_weights(7, 11, align))
        ww = torch.from_numpy(interpolate._resize_weights(5, 4, align))
        assert torch.equal(interpolate.resize_bilinear_nchw(x, (11, 4), align), (wh @ x) @ ww.T)
    xc = x.movedim(-3, -1)
    wh = torch.from_numpy(interpolate._resize_cubic_weights(7, 9, None))
    ww = torch.from_numpy(interpolate._resize_cubic_weights(5, 6, 1.2))
    ref = ((wh @ xc.movedim(-1, -3)) @ ww.T).movedim(-3, -1)
    assert torch.equal(interpolate.resize_bicubic_torch(xc, (9, 6), (None, 1.2)), ref)

    feats = torch.rand(2, 8, 8, 16, generator=gen)
    for splits in (1, 2):
        pos = position_embedding_sine(8 // splits, 8 // splits, 8)
        pos = np.tile(pos, (splits, splits, 1)) if splits > 1 else pos
        assert torch.equal(add_position_windowed(feats, splits, 16), feats + torch.from_numpy(pos))

    h, w, wh_, ww_, sh, sw = 8, 8, 4, 4, 2, 2
    img_mask = np.zeros((h, w), np.int64)
    cnt = 0
    for hs in (slice(0, -wh_), slice(-wh_, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww_), slice(-ww_, -sw), slice(-sw, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    blocks = torch.from_numpy(img_mask.reshape(2, wh_, 2, ww_).transpose(0, 2, 1, 3).reshape(4, wh_ * ww_))
    diff = blocks[:, None, :] - blocks[:, :, None]
    assert torch.equal(window.shifted_window_mask(h, w, wh_, ww_, sh, sw), torch.where(diff != 0, -100.0, 0.0))
    for m in (1, 2, 3):
        i_idx, l_idx = np.divmod(np.arange(m * 16), 16)
        assert torch.equal(device_array(window.key_order, m, 16, device="cpu", dtype=torch.int64),
                           torch.from_numpy((l_idx * m + i_idx) % 16))


def test_the_dav2_input_keeps_its_channel_shuffle(encoder, ctx):
    images = ctx[0]
    b, v, h, w, _ = images.shape
    ref = interpolate.resize_bilinear(normalize_images(images)[..., [2, 0, 1]].reshape(b * v, h, w, 3),
                                      (encoder.cfg.dav2_input_size,) * 2, align_corners=True)
    assert torch.equal(encoder.dav2_inputs(images), ref)
