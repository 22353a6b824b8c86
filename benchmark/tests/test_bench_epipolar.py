"""The pixelsplat-re10k-serve cell's whole run at a CPU size (64^2, the
published widths): correct, with its three compared numbers, and not
correct when the program's epipolar attention is skipped or when a pixel
keeps one depth for its three Gaussians."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import cellrun, spec

CPU = torch.device("cpu")


def _cell() -> spec.Cell:
    cell = spec.cell(spec.load_spec(), "pixelsplat-re10k-serve")
    cell.config["image_shape"] = [64, 64]
    cell.traffic.update(scenes=3, warmup=1)
    cell.traffic["trace"]["units"] = 2
    return cell


def _run(cell: spec.Cell) -> dict:
    torch.set_num_threads(4)
    return cellrun.run_cell(cell, 2**31 + 77, 1.0, False, CPU, time.perf_counter())


def test_a_run_is_correct():
    cell = _cell()
    result = _run(cell)
    assert result["correct"], result["checked"]
    assert set(result["checked"]) == {"gaussians_rel", "color_rel", "pick_mismatch_share"}
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert cellrun.forbidden_modules() == []


@pytest.mark.parametrize("fault", ["attention_skipped", "one_depth_a_pixel"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    from transplat_tpu_torch.model import encoder_epipolar as E

    if fault == "attention_skipped":
        monkeypatch.setattr(E.EpipolarTransformer, "attend", lambda self, x, z, shape: x)
    else:
        depths = E.EncoderEpipolar.depths

        def one_depth(self, *args):
            d, s, picks, pdf = depths(self, *args)
            return d[..., :1].expand_as(d).contiguous(), s, picks, pdf

        monkeypatch.setattr(E.EncoderEpipolar, "depths", one_depth)
    result = _run(_cell())
    assert not result["correct"]
    assert result["checked"]["gaussians_rel"]["value"] > result["checked"]["gaussians_rel"]["limit"]
