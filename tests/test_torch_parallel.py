"""Data parallelism (dp) and the view-sharded decode (sp) of the port on the CPU.

Ranks are spawned processes talking over gloo (transplat_tpu_torch.parallel
.launch.spawn), at the tiny configuration of __graft_entry__.py (64x64, two
target views). A dp x sp step is held against the one-process step on the
joined batch, from the same seeded state, every process on one torch thread,
through `dryrun.step_errors`: the loss, the gradient norm, the clipped
gradient whole (relative L2), leaf by leaf (the worst relative distance of
a leaf that carries at least 1e-6 of the norm, 1e-12 in float64: a fault in
a small subnetwork shows there; dryrun.CARRYING_LEAF) and the update's
cosine.

Tolerances (STEP_TOL), each a few times the reading on this tiny
configuration. An sp run's encoder forward is the one-process forward on
the same batch; its gradient sums the ranks' parts in another order: norm
3.1e-7, whole 1.1e-6, worst leaf 6.9e-4, update cosine 1 - 1.5e-7. A dp
run's encoder computes each example in a batch of one where the joined step
computes both in a batch of two, and float32 matrix products round
otherwise at another size: norm 3.4e-5, whole 1.0e-4, worst leaf 3.2e-3,
update cosine 1 - 6.4e-5 (Adam's first step moves each parameter by about
lr x the sign of its gradient, so the update is far more sensitive than the
gradient). The same dp step in float64 reads norm 3.8e-16, whole 4.7e-15,
worst of all 429 leaves that are not 0 by construction 1.5e-12: the
float32 gap is rounding, not a fault (STEP_TOL_F64 holds the float64
witness). Dropping the cross-rank sum from BatchNorm's
backward reads worst leaf 7.0, whole 5.1e-2, norm 9.5e-4 in both precisions.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from transplat_tpu_torch.config import load_config
from transplat_tpu_torch.dataset import chunks
from transplat_tpu_torch.model.types import Gaussians
from transplat_tpu_torch.parallel import Mesh, constrain, dryrun, launch
from transplat_tpu_torch.parallel.mesh import view_slice
from transplat_tpu_torch.training.trainer import Trainer, dropout_seed

import _torch_ranks

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The ranks run on one thread each (launch.spawn); the one-process
    reference does too, so that both round alike."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fake_mesh(dp: int, sp: int, rank: int) -> Mesh:
    """A Mesh without process groups, for the functions that read only its coordinates."""
    dp_rank, sp_rank = divmod(rank, sp)
    return Mesh(rank=rank, world=dp * sp, dp=dp, sp=sp, dp_rank=dp_rank, sp_rank=sp_rank, dp_group=None,
                sp_group=None, device=torch.device("cpu"), backend="gloo")


def test_make_mesh_layout_and_asserts():
    """rank = dp_rank * sp + sp_rank (JAX's reshape(dp, sp)); each dp group
    holds one sp rank of every dp block, each sp group one dp block; the
    batch splits over dp; a mesh that does not cover the world fails with
    JAX's message."""
    recs = launch.spawn(_torch_ranks.mesh_layout, 4, 2, 2, timeout_s=120)
    for r, rec in enumerate(recs):
        assert rec["rank"] == r and rec["world"] == 4 and rec["shape"] == {"dp": 2, "sp": 2}
        assert (rec["dp_rank"], rec["sp_rank"]) == divmod(r, 2)
        assert rec["members"]["sp"] == [2 * rec["dp_rank"], 2 * rec["dp_rank"] + 1]
        assert rec["members"]["dp"] == [rec["sp_rank"], 2 + rec["sp_rank"]]
        lo = 4 * rec["dp_rank"]
        assert rec["slice"] == slice(lo, lo + 4) and rec["x"] == list(range(lo, lo + 4))
        assert rec["scene"] == [f"s{i}" for i in range(lo, lo + 4)]
        assert rec["passes"] and rec["backend"] == "gloo"
        assert rec["refusal"] == "dp(5) * sp(1) != devices(4)"


def test_entry_points_default_to_the_card(monkeypatch):
    """make_mesh() without a card raises, naming device="cpu", before it
    touches a process group; the dry run's entry points default to the card."""
    import inspect

    from transplat_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA card; pass device="cpu"'):
        make_mesh()
    assert dryrun.StepSpec().device == "cuda"
    for fn in (dryrun.decode_rank, dryrun.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_spawn_returns_each_rank_and_reports_a_failure():
    """launch.spawn returns the ranks' results in rank order; a rank that
    raises fails the call with its traceback; ranks that outlast the
    timeout are stopped and fail it with TimeoutError."""
    assert launch.spawn(_torch_ranks.fail_on_rank, 3, -1, timeout_s=120) == [0, 1, 2]
    with pytest.raises(Exception, match="rank 1 broke"):
        launch.spawn(_torch_ranks.fail_on_rank, 2, 1, timeout_s=120)
    with pytest.raises(TimeoutError, match=r"ranks \[0(, 1)?\] of 2 ran past 3 s"):  # rank 1 may still be starting
        launch.spawn(_torch_ranks.fail_on_rank, 2, 0, True, timeout_s=3)


def test_constrain_and_view_slice_follow_the_mesh():
    """An sp rank keeps its g / sp Gaussians and renders its tv / sp views
    (all views when they do not split over sp); sp = 1 keeps everything."""
    g = Gaussians(*(torch.arange(2 * 8 * k, dtype=torch.float32).reshape(2, 8, *s)
                    for k, s in ((3, (3,)), (9, (3, 3)), (12, (3, 4)), (1, ()))))
    for rank in range(4):
        mesh = fake_mesh(2, 2, rank)
        local = constrain(g, mesh)
        lo = 4 * mesh.sp_rank
        for a, b in zip(local, g):
            assert torch.equal(a, b[:, lo : lo + 4])
        assert view_slice(4, mesh) == slice(2 * mesh.sp_rank, 2 * mesh.sp_rank + 2)
        assert view_slice(3, mesh) == slice(0, 3)
    assert constrain(g, fake_mesh(2, 1, 1)) is g and constrain(g, None) is g
    with pytest.raises(ValueError, match="do not split over sp = 3"):
        constrain(g, fake_mesh(1, 3, 0))


STEP_TOL = {  # float32; `dp` for any run with dp > 1
    "dp": {"loss_rtol": 1e-6, "stats_atol": 1e-6, "grad_norm_rtol": 1e-4, "clipped_grad_rel_l2": 3e-4,
           "worst_leaf_rel": 1e-2, "update_cos_min": 1 - 3e-4, "carrying": 1e-6},
    "sp": {"loss_rtol": 1e-6, "stats_atol": 1e-6, "grad_norm_rtol": 1e-5, "clipped_grad_rel_l2": 1e-5,
           "worst_leaf_rel": 3e-3, "update_cos_min": 1 - 1e-6, "carrying": 1e-6},
}
STEP_TOL_F64 = {"loss_rtol": 1e-12, "stats_atol": 1e-12, "grad_norm_rtol": 1e-12, "clipped_grad_rel_l2": 1e-12,
                "worst_leaf_rel": 1e-10, "update_cos_min": 1 - 1e-12, "carrying": 1e-12}


def _assert_step_matches(ranks: list, ref: dict, tol: dict) -> None:
    e = dryrun.step_errors(ranks, ref, tol["carrying"])
    assert e["finite"] and e["same_keys"] and e["same_metrics_on_every_rank"], e  # the world's metrics on every rank
    assert e["loss_rel_err"] <= tol["loss_rtol"], e
    assert e["grad_norm_rel_err"] <= tol["grad_norm_rtol"], e
    assert e["clipped_grad_rel_l2"] <= tol["clipped_grad_rel_l2"], e
    assert e["clipped_grad_worst_leaf_rel"] <= tol["worst_leaf_rel"], e
    assert e["update_cosine"] >= tol["update_cos_min"], e
    assert e["batch_norm_max_abs_err"] <= tol["stats_atol"], e  # the joined batch's statistics on every rank
    for rec in ranks:
        assert rec["norms"].keys() == ref["norms"].keys() and len(ref["norms"]) == 4


@pytest.mark.parametrize("float64", [False, True], ids=["float32", "float64"])
def test_dp2_step_equals_the_joined_batch_step(float64):
    """Two dp ranks, dropout off, against the joined batch's step; in
    float64 (the witness that the float32 gap is rounding) within 1e-12."""
    spec = dryrun.StepSpec(dp=2, return_params=True, float64=float64, device="cpu")
    ranks = launch.spawn(dryrun.step_rank, 2, spec, timeout_s=300)
    ref = dryrun.reference_step(spec)
    _assert_step_matches(ranks, ref, STEP_TOL_F64 if float64 else STEP_TOL["dp"])
    assert ranks[0]["traffic"]["gradients"] == ranks[0]["all_reduce"]["bytes"] > 0


def test_sp2_step_equals_the_one_rank_step():
    """dp = 1 x sp = 2 with dropout on (both sp ranks draw the one-rank
    step's masks): the same step as one process on the same batch; each
    rank's sharded decode of the eval-mode Gaussians equals the unsharded
    decode of its views (measured: equal)."""
    spec = dryrun.StepSpec(sp=2, dropout=True, return_params=True, decode_check=True, device="cpu")
    ranks = launch.spawn(dryrun.step_rank, 2, spec, timeout_s=300)
    ref = dryrun.reference_step(spec)
    _assert_step_matches(ranks, ref, STEP_TOL["sp"])
    for r, rec in enumerate(ranks):
        dec = rec["decode"]
        assert dec["views"] == [r, r + 1] and dec["finite"] and dec["max_abs_err"] <= 1e-5
        assert dec["gaussians_local"] * 2 == dec["gaussians"] == 2 * 64 * 64


def test_dp2_sp2_step_over_four_ranks():
    spec = dryrun.StepSpec(dp=2, sp=2, return_params=True, device="cpu")
    ranks = launch.spawn(dryrun.step_rank, 4, spec, timeout_s=300)
    ref = dryrun.reference_step(spec)
    _assert_step_matches(ranks, ref, STEP_TOL["dp"])
    assert [(r["dp_rank"], r["sp_rank"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_dropout_masks_follow_the_dp_rank(tmp_path):
    """The ranks of one dp group draw the same masks (one encoder forward
    between them), dp groups their own; dp rank 0 draws the one-process
    run's masks, and a step's masks do not depend on what came before."""
    cfg = load_config("re10k")
    cfg.checkpointing.save_dir = str(tmp_path / "ckpt")

    def masks(mesh, step):
        trainer = Trainer(cfg, mesh=mesh, device="cpu", log_fn=lambda m: None)
        trainer.global_step = step
        return torch.rand(256, generator=trainer._step_generator())

    for step in (0, 7):
        one = masks(None, step)
        draws = {(dp_rank, sp_rank): masks(fake_mesh(2, 2, 2 * dp_rank + sp_rank), step)
                 for dp_rank in range(2) for sp_rank in range(2)}
        assert torch.equal(draws[0, 0], draws[0, 1]) and torch.equal(draws[1, 0], draws[1, 1])
        assert not torch.equal(draws[0, 0], draws[1, 0])
        assert torch.equal(draws[0, 0], one)
    assert dropout_seed(0, 3, 0) != dropout_seed(0, 3, 1) != dropout_seed(0, 4, 1)


@pytest.mark.parametrize("workers", [0, 3])
def test_striped_chunks_are_disjoint_and_cover_every_chunk(tmp_path, workers):
    """Over dp = 3 (x sp = 2) with and without loader workers: each chunk is
    read by exactly one dp rank (one loader of it), and both sp ranks of a
    dp group read the same chunks with the same seeds."""
    root = tmp_path / "data"
    for i in range(7):
        (root / "train").mkdir(parents=True, exist_ok=True)
        (root / "train" / f"{i:06d}.torch").write_bytes(b"")
    cfg = load_config("re10k", dataset={"roots": [str(root)]})
    cfg.checkpointing.save_dir = str(tmp_path / "ckpt")
    seen, per_group = [], {}
    for rank in range(6):
        trainer = Trainer(cfg, mesh=fake_mesh(3, 2, rank), device="cpu", log_fn=lambda m: None)
        names = []
        for w in range(max(workers, 1)):
            shard = trainer.train_shard(w, workers)
            ds = trainer.make_dataset("train", **shard)
            names += [p.name for p in ds.chunks]
            per_group.setdefault(trainer.mesh.dp_rank, []).append((w, shard, [p.name for p in ds.chunks],
                                                                   ds.rng.random()))
        if trainer.mesh.sp_rank == 0:
            seen += names
    assert sorted(seen) == sorted(p.name for p in (root / "train").glob("*.torch"))
    assert len(seen) == len(set(seen)) == 7
    for group in per_group.values():  # the sp ranks' loaders, in order: equal shards, chunks and draws
        half = len(group) // 2
        assert group[:half] == group[half:]


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    """train/: 4 chunks of one 30-frame scene; test/: one 60-frame scene; 360x640."""
    root = tmp_path_factory.mktemp("dp_train")
    for i in range(4):
        chunks.write_chunk(root / "train" / f"{i:06d}.torch", [chunks.make_scene(f"tr_{i}", 30, seed=i)])
    chunks.write_chunk(root / "test" / "000000.torch", [chunks.make_scene("te_0", 60, seed=7)])
    return root


def _torchrun(args: list[str], cwd: Path, program: list[str] = ("-m", "transplat_tpu_torch.main")
              ) -> subprocess.CompletedProcess:
    """`main train --device cpu` on two ranks under torchrun; `--standalone`
    lets the rendezvous take a free port of its own."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")]), "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", *program,
         "train", "--device", "cpu", *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_main_train_dp2_one_writer_and_resume(train_root, tmp_path):
    """`main train --dp 2` under torchrun over seeded chunks: rank 0 alone
    writes the run directory, config, checkpoints, metric lines and media
    (one record per validation, not one per rank); a second run resumes
    from the checkpoint on every rank."""
    from test_torch_cli import TINY_YAML

    (tmp_path / "tiny.yaml").write_text(TINY_YAML.replace("num_sanity_val_steps: 1", "num_sanity_val_steps: 0"))
    common = ["--dp", "2", "--config", "tiny.yaml", "--dataset-root", str(train_root), "--output", "run"]
    first = _torchrun([*common, "--max-steps", "2"], tmp_path)
    assert first.returncode == 0, first.stdout[-3000:] + first.stderr[-3000:]
    assert first.stdout.count("run dir: run") == 1 and first.stdout.count("trained to step 2") == 1
    assert "; 2 for dp rank 0" in first.stdout and "; 2 for dp rank 1" in first.stdout
    run = tmp_path / "run"
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["config.json", "step_00000002.pt"]
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [2] and records[0]["val_scenes"] == ["te_0"]
    assert sorted(p.name for p in (run / "local").iterdir()) == [
        "projections_00000002.png", "validation_00000002.png", "wobble_00000002.mp4"]

    again = _torchrun([*common, "--max-steps", "4", "trainer.val_save_media=false"], tmp_path)
    assert again.returncode == 0, again.stdout[-3000:] + again.stderr[-3000:]
    assert "resumed from step 2 (rank 0 of 2)" in again.stdout and "resumed from step 2 (rank 1 of 2)" in again.stdout
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "config.json", "step_00000002.pt", "step_00000004.pt"]
    assert [json.loads(line)["step"] for line in (run / "metrics.jsonl").read_text().splitlines()] == [2, 4]


def test_main_train_sp2_ranks_take_one_batch_a_step(train_root, tmp_path):
    """`main train --dp 1 --sp 2` with two loader workers: sp rank 0 alone
    loads and broadcasts each batch, so both ranks train on the same batch
    at every step (a SHA-256 of each step's views, recorded on each rank by
    tests/_torch_sp_train.py); the steps do not all take one batch."""
    from test_torch_cli import TINY_YAML

    (tmp_path / "tiny.yaml").write_text(TINY_YAML.replace("num_sanity_val_steps: 1", "num_sanity_val_steps: 0")
                                        .replace("num_workers: 0", "num_workers: 2"))
    res = _torchrun(["--dp", "1", "--sp", "2", "--config", "tiny.yaml", "--dataset-root", str(train_root),
                     "--output", "run", "--max-steps", "4", "trainer.val_check_interval=1000"], tmp_path,
                    program=[str(ROOT / "tests" / "_torch_sp_train.py")])
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count("training chunk(s)") == 1  # one loader for the sp group
    ranks = [json.loads((tmp_path / f"batches_rank{r}.json").read_text()) for r in range(2)]
    assert len(ranks[0]) == 4 and ranks[0] == ranks[1]
    assert len(set(ranks[0])) > 1
