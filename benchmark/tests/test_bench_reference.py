"""The frozen reference against the port's plain path at tiny widths on the
CPU, and the reference's independence of the program and of JAX."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from benchmark.harness import serving, traffic
from benchmark.harness.spec import ROOT, build_dataclass
from benchmark.harness.weights import load_parameters

FORBIDDEN_FOR_REFERENCE = ("jax", "jaxlib", "flax", "transplat_tpu", "transplat_tpu_torch")


@pytest.mark.parametrize("name", ["re10k-serve", "dtu-nctx3-serve"])
def test_reference_matches_the_ports_plain_path(tiny_cell, name):
    from transplat_tpu_torch.model.decoder import DecoderCfg, decode_splatting
    from transplat_tpu_torch.model.encoder import EncoderCfg, EncoderTranSplat

    c = tiny_cell(name)
    weights = serving.seeded_weights(c.config, 3, "cpu")
    program = EncoderTranSplat(build_dataclass(EncoderCfg, c.config["encoder"]), device="cpu")
    load_parameters(program, weights)
    program.eval()
    reference = serving.reference_encoder(c.config, "cpu", weights)
    scene = traffic.make_scenes(c.traffic, c.config, 3, "cpu", count=1)[0]
    ctx, tgt = scene.context, scene.targets
    args = (ctx["image"], ctx["intrinsics"], ctx["extrinsics"], ctx["near"], ctx["far"])
    with torch.no_grad():
        g_prog, g_ref = program(*args), reference(*args)
        for f in serving.FIELDS:
            assert serving.rel_l2(getattr(g_prog, f), getattr(g_ref, f)) < 1e-6, f
        shape = tuple(c.config["image_shape"])
        colors = decode_splatting(g_prog, tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"], shape,
                                  cfg=build_dataclass(DecoderCfg, c.config["decoder"])).color
        from benchmark.reference.render import render_views

        ref_colors, kept = render_views(tuple(getattr(g_prog, f)[0] for f in serving.FIELDS), tgt["extrinsics"][0],
                                        tgt["intrinsics"][0], tgt["near"][0], shape, torch.zeros(3))
    assert kept > 0
    assert serving.rel_l2(colors[0], ref_colors) < 1e-5


def test_reference_and_harness_load_neither_the_program_nor_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import benchmark.reference.model.encoder, benchmark.reference.render, benchmark.harness.weights;"
        "import benchmark.harness.traffic, benchmark.metrics.counting;"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN_FOR_REFERENCE!r});"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_reference_sources_import_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        text = path.read_text()
        for name in ("transplat_tpu", "jax", "flax"):
            assert f"import {name}" not in text and f"from {name}" not in text, (path, name)


@pytest.mark.parametrize("cosine", [True, False])
def test_reference_schedule_follows_the_programs(cosine):
    from benchmark.reference.train import schedule
    from transplat_tpu_torch.training import make_lr_schedule

    program, reference = make_lr_schedule(2e-4, 3000, cosine, 200), schedule(2e-4, 3000, cosine, 200)
    for step in (0, 1, 2, 29, 30, 31, 199, 200, 201, 1500, 3000, 3011):
        assert reference(step) == pytest.approx(program(step), rel=1e-12, abs=0.0), step
