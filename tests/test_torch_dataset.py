"""The port's data path (transplat_tpu_torch.dataset) against the JAX package's.

Chunks come from a seed in the RE10K format (transplat_tpu_torch.dataset.chunks,
written with the host JPEG library); both packages read the same files. The
view samplers return equal indices from equal generator states; the shims,
example by example the chunk dataset, are equal in float32 (intrinsics within
1e-6 where they are recomputed); the loaders batch them, the forked one with
a curriculum that follows a shared step.
"""

import json
import multiprocessing as mp

import numpy as np
import pytest
import torch

from transplat_tpu.dataset import re10k as jre10k
from transplat_tpu.dataset import shims as jshims
from transplat_tpu.dataset import view_samplers as jvs
from transplat_tpu_torch.config import BoundedCfg, DatasetCfg
from transplat_tpu_torch.dataset import chunks, re10k, shims, view_samplers as vs
from transplat_tpu_torch.dataset.loader import DataLoader, MultiWorkerLoader


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny CPU models run thousands of small ops: with several test workers
    on one machine, each op's OpenMP threads oversubscribe the cores (the
    CLI tests' tiny training read 300 s in the parallel suite against 6 s
    alone). One thread per worker keeps the file at its own cost."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chunk_dir(tmp_path_factory):
    """train/: two chunks (2 scenes x 30 frames, 1 scene x 30); test/: one
    chunk of 2 scenes x 60 frames with other keys; frames 360x640."""
    root = tmp_path_factory.mktemp("re10k_port")
    chunks.write_chunk(root / "train" / "000000.torch",
                       [chunks.make_scene(f"train_{i}", 30, seed=i) for i in range(2)])
    chunks.write_chunk(root / "train" / "000001.torch", [chunks.make_scene("train_2", 30, seed=2)])
    chunks.write_chunk(root / "test" / "000000.torch",
                       [chunks.make_scene(f"test_{i}", 60, seed=10 + i) for i in range(2)])
    return root


# ---------------------------------------------------------------------------
# View samplers

BOUNDED = {
    "default": {},
    "no_warmup_margin": dict(warm_up_steps=0, min_distance_to_context_views=2, min_distance_between_context_views=8,
                             max_distance_between_context_views=20, num_target_views=3),
}


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("stage", ["train", "val", "test"])
@pytest.mark.parametrize("variant", sorted(BOUNDED))
def test_bounded_sampler_matches_jax(variant, stage, circular):
    kw = BOUNDED[variant]
    port = vs.ViewSamplerBounded(BoundedCfg(**kw), stage=stage, cameras_are_circular=circular)
    ref = jvs.ViewSamplerBounded(jvs.BoundedCfg(**kw), stage=stage, cameras_are_circular=circular)
    checked = 0
    for seed in range(4):
        for num_views in (20, 30, 60, 250):
            for step in (0, 37_500, 75_000, 149_999, 400_000):
                r_p, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
                try:
                    want = ref.sample("s", num_views, r_j, step)
                except ValueError:
                    with pytest.raises(ValueError, match="enough frames"):
                        port.sample("s", num_views, r_p, step)
                    continue
                got = port.sample("s", num_views, r_p, step)
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
                assert r_p.random() == r_j.random()  # the generators moved alike
                checked += 1
    assert checked > 0


def test_other_samplers_match_jax(tmp_path):
    index = {"a": {"context": [3, 50], "target": [10, 20, 30]}, "b": None}
    path = tmp_path / "index.json"
    path.write_text(json.dumps(index))
    ev, jev = vs.ViewSamplerEvaluation(path), jvs.ViewSamplerEvaluation(path)
    assert ev.scenes() == jev.scenes() == ["a"]
    for a, b in zip(ev.sample("a", 60), jev.sample("a", 60)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="No evaluation entry"):
        ev.sample("b", 60)
    for kw in ({}, dict(num_context_views=3, num_target_views=2), dict(context_views=[1, 4], target_views=[2])):
        got = vs.ViewSamplerArbitrary(vs.ArbitraryCfg(**kw)).sample("s", 40, np.random.default_rng(5))
        want = jvs.ViewSamplerArbitrary(jvs.ArbitraryCfg(**kw)).sample("s", 40, np.random.default_rng(5))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(vs.ViewSamplerAll().sample("s", 7), jvs.ViewSamplerAll().sample("s", 7)):
        np.testing.assert_array_equal(a, b)
    for name, kw in (("bounded", {}), ("evaluation", dict(index_path=path)), ("arbitrary", {}), ("all", {})):
        port, ref = vs.get_view_sampler(name, **kw), jvs.get_view_sampler(name, **kw)
        assert type(port).__name__ == type(ref).__name__
        assert (port.num_context_views, port.num_target_views) == (ref.num_context_views, ref.num_target_views)
    with pytest.raises(ValueError, match="unknown view sampler"):
        vs.get_view_sampler("nope")


# ---------------------------------------------------------------------------
# Poses and shims

def test_convert_poses_matches_jax():
    rng = np.random.default_rng(0)
    poses = chunks.orbit_poses(50, yaw_deg_per_frame=0.7)
    poses[:, :4] = rng.uniform(0.4, 1.2, (50, 4)).astype(np.float32)
    got, want = re10k.convert_poses(poses), jre10k.convert_poses(poses)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(re10k._fov_deg(got[1]), jre10k._fov_deg(want[1]))


def _example(rng, v, hw):
    return {
        "image": rng.random((v, *hw, 3)).astype(np.float32),
        "intrinsics": np.tile(np.array([[0.9, 0, 0.5], [0, 1.1, 0.45], [0, 0, 1]], np.float32), (v, 1, 1)),
        "extrinsics": rng.standard_normal((v, 4, 4)).astype(np.float32),
    }


@pytest.mark.parametrize("hw,shape", [((360, 640), (256, 256)), ((90, 160), (64, 64)), ((60, 45), (48, 32))])
def test_crop_shim_matches_jax(hw, shape):
    rng = np.random.default_rng(1)
    ex = {"context": _example(rng, 2, hw), "target": _example(rng, 3, hw), "scene": "s"}
    got, want = shims.apply_crop_shim(ex, shape), jshims.apply_crop_shim(ex, shape)
    for key in ("context", "target"):
        np.testing.assert_array_equal(got[key]["image"], want[key]["image"])
        assert got[key]["image"].dtype == np.float32 and got[key]["image"].shape[1:3] == shape
        np.testing.assert_allclose(got[key]["intrinsics"], want[key]["intrinsics"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(shims.rescale_batch(ex["context"]["image"], (50, 70)),
                                  jshims.rescale_batch(ex["context"]["image"], (50, 70)))
    with pytest.raises(ValueError, match="larger"):
        shims.rescale_and_crop(ex["context"]["image"], ex["context"]["intrinsics"], (hw[0] + 1, hw[1]))


def test_augmentation_and_patch_shims_match_jax():
    rng = np.random.default_rng(2)
    ex = {"context": _example(rng, 2, (8, 12)), "target": _example(rng, 1, (8, 12)), "scene": "s"}
    flips = 0
    for seed in range(8):
        r_p, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = shims.apply_augmentation_shim(ex, r_p), jshims.apply_augmentation_shim(ex, r_j)
        flips += got is not ex
        for key in ("context", "target"):
            np.testing.assert_array_equal(got[key]["image"], want[key]["image"])
            np.testing.assert_array_equal(got[key]["extrinsics"], want[key]["extrinsics"])
    assert 0 < flips < 8
    batch = {k: {"image": np.zeros((1, 2, 30, 45, 3), np.float32),
                 "intrinsics": np.tile(np.eye(3, dtype=np.float32), (1, 2, 1, 1))} for k in ("context", "target")}
    for patch in (14, 16, 15):
        got, want = shims.apply_patch_shim(batch, patch), jshims.apply_patch_shim(batch, patch)
        for key in ("context", "target"):
            assert got[key]["image"].shape == want[key]["image"].shape
            np.testing.assert_allclose(got[key]["intrinsics"], want[key]["intrinsics"], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The chunk dataset

def _datasets(chunk_dir, stage, tmp_path):
    cfg_kw = dict(roots=[str(chunk_dir)], image_shape=(64, 64))
    if stage == "test":
        index = {"test_0": {"context": [5, 52], "target": [10, 30, 50]}, "test_1": None}
        path = tmp_path / "index.json"
        path.write_text(json.dumps(index))
        port_s, jax_s = vs.ViewSamplerEvaluation(path), jvs.ViewSamplerEvaluation(path)
    else:
        port_s = vs.ViewSamplerBounded(BoundedCfg(), stage=stage)
        jax_s = jvs.ViewSamplerBounded(jvs.BoundedCfg(), stage=stage)
    port = re10k.ChunkDataset(DatasetCfg(**cfg_kw), stage, port_s, seed=3)
    ref = jre10k.ChunkDataset(jre10k.DatasetCfg(**cfg_kw), stage, jax_s, seed=3)
    return port, ref


@pytest.mark.parametrize("stage", ["train", "val", "test"])
def test_chunk_dataset_matches_jax(chunk_dir, stage, tmp_path):
    """Two passes (the second with a later curriculum step): the same scenes,
    view indices, images, cameras and bounds, example by example."""
    port, ref = _datasets(chunk_dir, stage, tmp_path)
    assert [p.name for p in port.chunks] == [p.name for p in ref.chunks]
    for step in (0, 20_000):
        got = list(port.iter_examples(lambda: step))
        want = list(ref.iter_examples(lambda: step))
        assert [e["scene"] for e in got] == [e["scene"] for e in want]
        assert len(got) == {"train": 3, "val": 2, "test": 1}[stage]
        for a, b in zip(got, want):
            for key in ("context", "target"):
                np.testing.assert_array_equal(a[key]["index"], b[key]["index"])
                np.testing.assert_array_equal(a[key]["image"], b[key]["image"])
                assert a[key]["image"].dtype == np.float32 and a[key]["image"].shape[1:] == (64, 64, 3)
                np.testing.assert_array_equal(a[key]["extrinsics"], b[key]["extrinsics"])
                np.testing.assert_allclose(a[key]["intrinsics"], b[key]["intrinsics"], rtol=0, atol=1e-6)
                for k in ("near", "far"):
                    np.testing.assert_array_equal(a[key][k], b[key][k])
    if stage == "val":
        assert {e["scene"] for e in got} == {"test_0", "test_1"}  # the held-out split


def test_chunk_dataset_pending_examples_finish_alike(chunk_dir):
    """Sampled in one place and finished in another (the card's decoder
    route), an example equals the one finished where it was sampled."""
    cfg = DatasetCfg(roots=[str(chunk_dir)], image_shape=(48, 64))

    def dataset():
        return re10k.ChunkDataset(cfg, "train", vs.ViewSamplerBounded(BoundedCfg(), "train"), seed=9)

    whole = list(dataset())
    pending = list(dataset().iter_examples(decode=False))
    assert all(isinstance(b, bytes) for p in pending for b in p["context"]["image"])
    for a, p in zip(whole, pending, strict=True):
        b = re10k.finish_example(p, cfg.image_shape)
        for key in ("context", "target"):
            np.testing.assert_array_equal(a[key]["image"], b[key]["image"])
            np.testing.assert_array_equal(a[key]["extrinsics"], b[key]["extrinsics"])


def test_a_pass_that_yields_nothing_raises(chunk_dir):
    """Every frame has another shape than expected_shape: where the JAX
    reader yields nothing (and its loader waits forever), the port raises."""
    cfg = DatasetCfg(roots=[str(chunk_dir)], image_shape=(64, 64), expected_shape=(100, 100))
    ds = re10k.ChunkDataset(cfg, "train", vs.ViewSamplerBounded(BoundedCfg(), "train"))
    with pytest.raises(RuntimeError, match="yielded no example"):
        list(ds)
    assert list(jre10k.ChunkDataset(jre10k.DatasetCfg(**vars(cfg)), "train",
                                    jvs.ViewSamplerBounded(jvs.BoundedCfg(), "train"))) == []
    empty = re10k.ChunkDataset(DatasetCfg(roots=[str(chunk_dir / "nowhere")]), "train", None)
    assert empty.chunks == [] and list(empty) == []


# ---------------------------------------------------------------------------
# Loaders

def test_data_loader_batches(chunk_dir):
    cfg = DatasetCfg(roots=[str(chunk_dir)], image_shape=(32, 32))
    ds = re10k.ChunkDataset(cfg, "val", vs.ViewSamplerBounded(BoundedCfg(num_target_views=2), "val"))
    batches = list(DataLoader(ds, batch_size=2))
    assert len(batches) == 1 and batches[0]["scene"] == ["test_0", "test_1"]
    assert batches[0]["context"]["image"].shape == (2, 2, 32, 32, 3)
    assert batches[0]["target"]["index"].shape == (2, 2)
    assert len(list(DataLoader(ds, batch_size=3, drop_last=False))) == 1


def test_multi_worker_loader_follows_the_shared_step(chunk_dir):
    """Two forked workers, each with its own chunk; the curriculum's context
    gap follows a multiprocessing.Value the consumer moves (5 at step 0,
    20 from step 100 on)."""
    cfg = DatasetCfg(roots=[str(chunk_dir)], image_shape=(32, 32))
    bounded = BoundedCfg(warm_up_steps=100, initial_min_distance_between_context_views=5,
                         initial_max_distance_between_context_views=5, min_distance_between_context_views=20,
                         max_distance_between_context_views=20, num_target_views=1)
    shared = mp.get_context("fork").Value("l", 0)

    def make_worker_iter(w):
        ds = re10k.ChunkDataset(cfg, "train", vs.ViewSamplerBounded(bounded, "train"), seed=w, shard_id=w,
                                num_shards=2)

        def epochs():
            while True:
                yield from ds.iter_examples(lambda: shared.value)

        return epochs()

    gaps, scenes = [], set()
    for i, batch in enumerate(MultiWorkerLoader(make_worker_iter, num_workers=2, batch_size=1, prefetch=1)):
        assert batch["context"]["image"].shape == (1, 2, 32, 32, 3)
        gaps.append(int(np.diff(batch["context"]["index"][0])[0]))
        scenes.add(batch["scene"][0])
        if i == 1:
            shared.value = 100
        if gaps[-1] == 20 or i > 40:
            break
    assert gaps[0] == 5 and gaps[-1] == 20 and scenes <= {"train_0", "train_1", "train_2"}


def test_multi_worker_loader_ends_or_raises(chunk_dir):
    cfg = DatasetCfg(roots=[str(chunk_dir)], image_shape=(32, 32))

    def one_pass(w):
        return re10k.ChunkDataset(cfg, "val", vs.ViewSamplerBounded(BoundedCfg(), "val"), shard_id=w, num_shards=2)

    batches = list(MultiWorkerLoader(one_pass, num_workers=2, batch_size=1, finite=True))
    assert [b["scene"][0] for b in batches] == ["test_0", "test_1"]  # one test chunk: worker 1 has none
    # a loader whose endless workers all end raises, where the JAX loader would stop
    with pytest.raises(RuntimeError, match="ran out"):
        list(MultiWorkerLoader(one_pass, num_workers=2, batch_size=1))
    # a worker's error reaches the consumer with its traceback
    bad = DatasetCfg(roots=[str(chunk_dir)], image_shape=(32, 32), expected_shape=(10, 10))

    def failing(w):
        return re10k.ChunkDataset(bad, "val", vs.ViewSamplerBounded(BoundedCfg(), "val"))

    with pytest.raises(RuntimeError, match="yielded no example"):
        list(MultiWorkerLoader(failing, num_workers=2, batch_size=1, finite=True))
    # finished in the consumer: pending examples from the workers
    finished = list(MultiWorkerLoader(
        lambda w: one_pass(w).iter_examples(decode=False), num_workers=2, batch_size=1, finite=True,
        finish=lambda p: re10k.finish_example(p, (32, 32)),
    ))
    np.testing.assert_array_equal(finished[0]["context"]["image"], batches[0]["context"]["image"])
