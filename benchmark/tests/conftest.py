"""Shared fixtures: the benchmark's cells cut to a CPU-sized model.

A tiny cell keeps its traffic mix and its limits and narrows the model
(the widths of the port's own CPU rehearsals, `train_demo.tiny_encoder_cfg`)
and the images, so that a whole run of the harness takes seconds here.
"""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import spec

TINY_ENCODER = dict(
    d_feature=16, num_depth_candidates=16, costvolume_unet_feat_dim=16, costvolume_unet_channel_mult=[1, 1],
    costvolume_unet_attn_res=[2], depth_unet_feat_dim=8, depth_unet_attn_res=[4], depth_unet_channel_mult=[1, 1, 1],
    dav2_encoder="vits", dav2_input_size=28,
    gaussian_adapter={"gaussian_scale_min": 0.5, "gaussian_scale_max": 15.0, "sh_degree": 1},
)


def tiny(cell: spec.Cell) -> spec.Cell:
    cell.config["encoder"].update(TINY_ENCODER)
    cell.config["image_shape"] = [64, 64]
    cell.traffic.update(scenes=3, warmup=1)
    cell.traffic["trace"]["units"] = 2
    if cell.traffic["kind"] == "view":
        cell.traffic["frames"] = 2
    if cell.traffic["kind"] == "train":
        cell.traffic.update(scenes=4, warmup=0)
    return cell


@pytest.fixture
def tiny_cell():
    torch.set_num_threads(4)
    return lambda name: tiny(spec.cell(spec.load_spec(), name))


def pytest_addoption(parser):
    parser.addoption("--seeds", type=int, nargs="+", default=[2**31 + 5, 2**31 + 6, 2**31 + 7],
                     help="seeds of the control test on the card")
    parser.addoption("--cells", nargs="+", default=[], help="cells of the control test on the card (default: all)")


@pytest.fixture
def control_seeds(request):
    return request.config.getoption("--seeds")


@pytest.fixture
def control_cells(request):
    return request.config.getoption("--cells")


@pytest.fixture
def cuda_device():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
