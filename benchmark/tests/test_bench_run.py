"""Whole runs of the harness at a CPU size: each cell's run is correct and
loads nothing of JAX, and a run whose timed path is broken underneath
comes out not correct.

These runs skip the harness's look for a card (`run.py` refuses to run
without one) and drive the rest of a run: set-up, the window, the traced
window, the comparison with the reference, the result.
"""

from __future__ import annotations

import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import cellrun, spec

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]
SERVING = [n for n in CELLS if spec.cell(spec.load_spec(), n).traffic["kind"] in ("serve", "view")]
TRAINING = [n for n in CELLS if n not in SERVING]
CPU = torch.device("cpu")


def _run(cell, trace=False, seed=2**31 + 77):
    return cellrun.run_cell(cell, seed, 1.0, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct_and_loads_no_jax(tiny_cell, name):
    c = tiny_cell(name)
    result = _run(c)
    assert result["correct"], result["checked"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in c.end_to_end}
    assert list(result)[-1] == "checked" and set(result["checked"]) == set(c.traffic["check"]["limits"])
    assert cellrun.forbidden_modules() == []


def test_a_traced_run_prints_no_device_metric_from_the_cpu(tiny_cell):
    result = _run(tiny_cell("re10k-serve"), trace=True)
    assert result["correct"]
    assert result["metrics"] == {}  # every per-layer metric here is read from device ops
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def _altered_colors(decode):
    def altered(*args, **kwargs):
        out = decode(*args, **kwargs)
        color = out.color.clone()
        color[..., 5, 7, :] += 0.5
        return out._replace(color=color)

    return altered


@pytest.mark.parametrize("name", SERVING)
def test_a_rendered_answer_altered_where_it_is_produced_is_not_correct(tiny_cell, monkeypatch, name):
    from transplat_tpu_torch import inference
    from transplat_tpu_torch.model import decoder

    monkeypatch.setattr(inference, "decode_splatting", _altered_colors(inference.decode_splatting))
    monkeypatch.setattr(decoder, "decode_splatting", _altered_colors(decoder.decode_splatting))
    result = _run(tiny_cell(name))
    assert not result["correct"]
    assert result["checked"]["color_rel"]["value"] > result["checked"]["color_rel"]["limit"]


@pytest.mark.parametrize("name", SERVING)
def test_a_context_views_gaussians_left_out_are_not_correct(tiny_cell, monkeypatch, name):
    from transplat_tpu_torch.model.encoder import EncoderTranSplat

    forward = EncoderTranSplat.forward

    def one_view_left_out(self, *args, **kwargs):
        g = forward(self, *args, **kwargs)
        opacities = g.opacities.clone()
        opacities[:, : opacities.shape[1] // self.cfg.num_context_views] = 0.0
        return g._replace(opacities=opacities)

    monkeypatch.setattr(EncoderTranSplat, "forward", one_view_left_out)
    result = _run(tiny_cell(name))
    assert not result["correct"]
    assert result["checked"]["gaussians_rel"]["value"] > result["checked"]["gaussians_rel"]["limit"]


@pytest.mark.parametrize("name", TRAINING)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(tiny_cell, monkeypatch, name):
    from transplat_tpu_torch.training import step

    def frozen(self, params, grads, state):
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))

    monkeypatch.setattr(step.ClipAdam, "update", frozen)
    result = _run(tiny_cell(name))
    assert not result["correct"]
    assert result["checked"]["change_median_gap"]["value"] == pytest.approx(1.0)
    assert result["checked"]["grad_median_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAINING)
def test_a_step_on_half_of_the_batch_is_not_correct(tiny_cell, monkeypatch, name):
    from transplat_tpu_torch.training import step

    loss_and_grads = step.loss_and_grads

    def half(state, batch, *args, **kwargs):
        n = batch["context"]["image"].shape[0] // 2
        kept = {part: {k: v[:n] for k, v in views.items()} for part, views in batch.items()}
        return loss_and_grads(state, kept, *args, **kwargs)

    monkeypatch.setattr(step, "loss_and_grads", half)
    result = _run(tiny_cell(name))
    assert not result["correct"]


def test_run_py_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", "re10k-serve", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("section,key,value", [("trainer", "no_such_key", 1), ("trainer", "num_workers", 8),
                                               ("optimizer", "no_such_key", 1), ("loss", "depth_weight", 0.1)])
def test_a_training_key_that_is_not_followed_is_refused(tiny_cell, section, key, value):
    from benchmark.harness.kinds import train

    c = tiny_cell(TRAINING[0])
    c.config[section][key] = value
    with pytest.raises((KeyError, ValueError)):
        train.Driver(c, 3, CPU)


@pytest.mark.parametrize("switch", [False, True])
def test_the_training_step_gets_the_configurations_switches(tiny_cell, monkeypatch, switch):
    from benchmark.harness.kinds import train
    from transplat_tpu_torch import training

    seen = {}
    make_train_step = training.make_train_step

    def recording(*args, **kwargs):
        seen.update(kwargs)
        return make_train_step(*args, **kwargs)

    monkeypatch.setattr(training, "make_train_step", recording)
    c = tiny_cell(TRAINING[0])
    c.config["trainer"]["deterministic_kernels"] = switch
    c.config["optimizer"]["cosine_lr"] = False
    driver = train.Driver(c, 3, CPU)
    assert seen["deterministic_kernels"] is switch
    assert driver.opt.cosine_lr is False and driver.trainer.deterministic_kernels is switch


@pytest.mark.parametrize("name", TRAINING)
def test_a_gradient_wrong_in_one_leaf_is_not_correct(tiny_cell, monkeypatch, name):
    from transplat_tpu_torch.training import step

    loss_and_grads = step.loss_and_grads

    def one_leaf_off(*args, **kwargs):
        metrics, grads = loss_and_grads(*args, **kwargs)
        largest = max(grads, key=lambda k: float(torch.linalg.vector_norm(grads[k])))
        grads[largest] = grads[largest] * 1.5
        return metrics, grads

    monkeypatch.setattr(step, "loss_and_grads", one_leaf_off)
    result = _run(tiny_cell(name))
    assert not result["correct"]
    assert result["checked"]["grad_leaf_gap"]["value"] > result["checked"]["grad_leaf_gap"]["limit"]
