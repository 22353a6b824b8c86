"""The traffic generator repeats exactly from its seed, and changes with it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import spec, traffic
from benchmark.harness.trajectory import video_cameras

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]
BIG_SEED = 2**31 + 987_654_321


def _flat(scenes) -> list[torch.Tensor]:
    return [t for s in scenes for views in (s.context, s.targets) for t in views.values()]


@pytest.mark.parametrize("name", CELLS)
def test_scenes_repeat_from_the_seed(tiny_cell, name):
    c = tiny_cell(name)
    a = traffic.make_scenes(c.traffic, c.config, BIG_SEED, "cpu")
    b = traffic.make_scenes(c.traffic, c.config, BIG_SEED, "cpu")
    other = traffic.make_scenes(c.traffic, c.config, BIG_SEED + 1, "cpu")
    assert len(a) == c.traffic["scenes"]
    assert all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b)))
    assert not torch.equal(a[0].context["image"], other[0].context["image"])
    assert not torch.equal(a[0].context["extrinsics"], other[0].context["extrinsics"])
    # Every seed gives the same shapes: only the content changes.
    assert [x.shape for x in _flat(a)] == [x.shape for x in _flat(other)]


@pytest.mark.parametrize("name", CELLS)
def test_scenes_are_well_formed(tiny_cell, name):
    c = tiny_cell(name)
    (s, *_) = traffic.make_scenes(c.traffic, c.config, 5, "cpu")
    v, t = c.config["encoder"]["num_context_views"], c.traffic["target_views"]
    h, w = c.config["image_shape"]
    assert s.context["image"].shape == (1, v, h, w, 3)
    assert float(s.context["image"].min()) >= 0.0 and float(s.context["image"].max()) <= 1.0
    assert s.targets["extrinsics"].shape == (1, t, 4, 4)
    rot = s.context["extrinsics"][0, :, :3, :3].double()
    assert torch.allclose(rot @ rot.transpose(-1, -2), torch.eye(3, dtype=torch.float64).expand_as(rot), atol=1e-5)


def test_request_order_repeats_and_never_repeats_a_scene_back_to_back():
    mix = traffic.load("re10k-index")
    a, b = traffic.request_order(mix, BIG_SEED), traffic.request_order(mix, BIG_SEED)
    assert np.array_equal(a, b)
    assert sorted(a.tolist()) == list(range(mix["scenes"]))
    cycle = np.concatenate([a, a])
    assert np.all(cycle[1:] != cycle[:-1])
    assert not np.array_equal(a, traffic.request_order(mix, BIG_SEED + 1))


def test_video_cameras_follow_the_evaluator():
    extr = np.tile(np.eye(4), (2, 1, 1))
    extr[1, 0, 3] = 1.0
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]), (2, 1, 1))
    e, k = video_cameras(extr, intr, 5)
    assert e.shape == (10, 4, 4) and k.shape == (10, 3, 3)
    assert np.allclose(e[5], extr[0]) and np.allclose(e[9], extr[1])  # the interpolation's ends
    assert np.allclose(e[0], extr[0])  # the wobble starts at the first view (radius 0 at t = 0)
