"""The port's spans and counters (transplat_tpu_torch/utils/trace.py) on the
CPU, with train_demo's tiny encoder and the plain paths: each layer opens its
spans under a profiler, the samplers' backwards included; with no profiler
the program enters no record_function and computes the same bits; the render
counts its tile pairs and views."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from transplat_tpu_torch.dataset import synthetic_batch
from transplat_tpu_torch.evaluation.staged import StagedEncoder
from transplat_tpu_torch.inference import init_random, re10k_decoder_cfg
from transplat_tpu_torch.model.decoder import decode_splatting
from transplat_tpu_torch.model.encoder import STAGES, EncoderTranSplat
from transplat_tpu_torch.ops import deform
from transplat_tpu_torch.ops.rasterizer import api
from transplat_tpu_torch.ops.rasterizer.binning import bin_gaussians, sort_by_depth
from transplat_tpu_torch.train_demo import build, tiny_encoder_cfg
from transplat_tpu_torch.utils import trace
from transplat_tpu_torch.utils.benchmarker import Benchmarker

SHAPE = (64, 64)
RENDER_STEPS = ["render.project", "render.sort", "render.bin", "render.composite"]
CONTEXT = ("image", "intrinsics", "extrinsics", "near", "far")


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    encoder = EncoderTranSplat(tiny_encoder_cfg(), device="cpu")
    init_random(encoder, 0)
    batch = synthetic_batch(0, batch_size=1, num_context=2, num_target=3, image_shape=SHAPE)
    ctx = tuple(torch.as_tensor(batch["context"][k]) for k in CONTEXT)
    tgt = {k: torch.as_tensor(v) for k, v in batch["target"].items()}
    return encoder, batch, ctx, tgt


def _serve(model):
    """A request's Gaussians and colours, as inference.render_novel_views runs them."""
    encoder, _, ctx, tgt = model
    with torch.no_grad():
        g = encoder(*ctx)
        out = decode_splatting(g, tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"], SHAPE,
                               cfg=re10k_decoder_cfg())
    return g, out.color


def _samplers_forward_and_backward():
    gen = torch.Generator().manual_seed(3)
    h, w, q, d, p, c = 6, 7, 5, 3, 2, 4
    scores = torch.randn(2, q, h * w, generator=gen, requires_grad=True)
    value = torch.randn(2, h * w, c, generator=gen, requires_grad=True)
    loc_s = torch.rand(2, q, d, p, 2, generator=gen, requires_grad=True)
    loc_v = torch.rand(2, q, p, 2, generator=gen, requires_grad=True)
    aw_s = torch.rand(2, q, d, p, generator=gen, requires_grad=True)
    aw_v = torch.rand(2, q, p, generator=gen, requires_grad=True)
    out = deform.deform_sample_scores(scores, (h, w), loc_s, aw_s).sum()
    out = out + deform.deform_sample_vectors(value, (h, w), loc_v, aw_v).sum()
    torch.autograd.grad(out, [scores, value, loc_s, loc_v, aw_s, aw_v])


def _staged(model):
    encoder, batch, _, _ = model
    bench = Benchmarker("cpu")
    StagedEncoder(encoder).run(batch["context"], benchmarker=bench)
    assert list(bench.summarize()) == STAGES  # the caller's own context, inside each span


CASES = {
    "encoder": (lambda m: _serve(m), STAGES, STAGES),
    "staged encoder": (_staged, STAGES, STAGES),
    "render": (lambda m: _serve(m), RENDER_STEPS, RENDER_STEPS),
    # Autograd runs the later sampler's backward first.
    "samplers": (lambda m: _samplers_forward_and_backward(),
                 ["deform.scores", "deform.vectors", "deform.scores_bwd", "deform.vectors_bwd"],
                 ["deform.scores", "deform.vectors", "deform.vectors_bwd", "deform.scores_bwd"]),
}


def _recorded(fn, names) -> list[str]:
    """The spans among `names` that `fn()` opened under the profiler, in order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = sorted((e for e in prof.events() if e.name in names), key=lambda e: e.time_range.start)
    return [e.name for e in events]


@pytest.mark.parametrize("case", list(CASES))
def test_each_layer_records_its_spans_once_each_in_order(model, case):
    fn, names, order = CASES[case]
    assert _recorded(lambda: fn(model), names) == order


@pytest.fixture
def entries(monkeypatch):
    """The number of record_function ranges entered, by anyone, so far."""
    count = [0]
    enter = torch.autograd.profiler.record_function.__enter__

    def counted(self):
        count[0] += 1
        return enter(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counted)
    return count


def test_without_a_profiler_the_program_enters_no_record_function(entries):
    state, step, batch, gen = build(tiny_encoder_cfg(), SHAPE, torch.device("cpu"), seed=0, num_target=2)
    step(state, batch, gen)  # every span: the train.* spans, the stages, the samplers both ways, the render
    assert entries[0] == 0
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, batch, gen)
    assert entries[0] >= 6 + len(STAGES) + 4 + len(RENDER_STEPS)


def test_a_profiler_changes_no_bit_of_the_gaussians_or_colours(model):
    plain_g, plain_c = _serve(model)
    with profile(activities=[ProfilerActivity.CPU]):
        traced_g, traced_c = _serve(model)
    assert all(torch.equal(a, b) for a, b in zip(plain_g, traced_g))
    assert torch.equal(plain_c, traced_c)


def _render_args(model):
    g, _ = _serve(model)
    _, _, _, tgt = model
    views = tgt["extrinsics"].shape[1]
    rep = lambda x: x.expand(views, *x.shape[1:])  # noqa: E731
    cams = [tgt[k][0] for k in ("extrinsics", "intrinsics", "near", "far")]
    return (*cams, SHAPE, torch.zeros(views, 3), rep(g.means), rep(g.covariances), rep(g.harmonics),
            rep(g.opacities))


def test_the_render_counts_its_tile_pairs_and_views(model):
    args = _render_args(model)
    views = args[0].shape[0]
    proj = api.project_views(*args[:3], *args[6:], image_shape=SHAPE)
    pairs = bin_gaussians(sort_by_depth(proj)[0], SHAPE).idx.numel()
    assert pairs > 0
    trace.reset_counters()
    with torch.no_grad():
        api.render(*args)
        api.render(*args)
    # On the CPU both renders take the plain projection (render.project.plain).
    assert trace.counters() == {"render.pairs": 2 * pairs, "render.views": 2 * views, "render.project.plain": 2}


def test_reset_clears_the_counters(model):
    with torch.no_grad():
        api.render(*_render_args(model))
    assert trace.counters()["render.views"] > 0
    trace.reset_counters()
    assert trace.counters() == {}
